"""Hazard verifier for staged ``page_gather``/``page_scatter`` plans.

A *migration plan* is the batch of frame copies one policy interval
stages in the serving data plane (``TieredKVCache``): each op copies a
page payload from a source global frame to a destination global frame.
The Pallas kernels execute such a plan as one gather (all sources read)
followed by one scatter (all destinations written) per direction —
"gathers-first" staging — while the eager reference path applies each
copy in recorded order — "sequential" staging.

The two stagings have different hazard sets, and that difference is the
point of this verifier: a plan where a promotion sources a frame that an
earlier demotion overwrote (read-after-write frame reuse) is *correct*
under gathers-first staging and silently corrupts payloads under
sequential staging.  Any refactor of the data plane that reorders or
splits the batch must re-verify its plans — statically here, or inline
per flush in debug builds (``TIERSAN_PLAN_CHECK=1``).

Hazard kinds:

* ``out-of-range``   — a frame index outside ``[0, num_frames)``.
* ``dup-dst``        — two ops write the same destination frame with
  different sources (scatter write order is unspecified, so the final
  payload is nondeterministic).  Duplicate writes of the *same* source
  are allowed, matching the kernel contract.
* ``trash-misuse``   — the trash frame (garbage padding target) used as
  the source of a real copy, or a real payload discarded into trash.
* ``raw-frame-reuse``— *(sequential staging only)* an op reads a frame
  a previous op already overwrote: it copies the new payload, not the
  pre-interval one.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

#: Supported execution models for a plan.
STAGINGS = ("sequential", "gathers-first")


@dataclasses.dataclass(frozen=True)
class CopyOp:
    """One staged page copy in global-frame space."""

    pid: int
    src: int  # global frame read
    dst: int  # global frame written
    demote: bool = False  # fast->slow (direction tag, informational)


@dataclasses.dataclass(frozen=True)
class Hazard:
    kind: str
    op_index: int
    message: str
    other_index: Optional[int] = None

    def __str__(self) -> str:
        return f"[{self.kind}] op#{self.op_index}: {self.message}"


class PlanHazardError(RuntimeError):
    """Raised by :func:`check_plan` when a plan has hazards."""

    def __init__(self, hazards: Sequence[Hazard]) -> None:
        self.hazards = list(hazards)
        lines = "\n  ".join(str(h) for h in self.hazards)
        super().__init__(
            f"migration plan has {len(self.hazards)} hazard(s):\n  {lines}"
        )


def plan_from_staged(staged: Iterable) -> List[CopyOp]:
    """Adapt ``TieredKVCache`` staged copies (``pid/src/dst/demote``
    duck-typed) into a verifiable plan."""
    return [
        CopyOp(pid=int(c.pid), src=int(c.src), dst=int(c.dst),
               demote=bool(c.demote))
        for c in staged
    ]


def verify_plan(
    ops: Sequence[CopyOp],
    *,
    num_frames: Optional[int] = None,
    trash_frame: Optional[int] = None,
    staging: str = "gathers-first",
) -> List[Hazard]:
    """Check a plan; returns all hazards (empty list = safe).

    ``num_frames`` is the size of the global frame space (trash frame
    included); ``staging`` selects the execution model the plan will run
    under (see module docstring).
    """
    if staging not in STAGINGS:
        raise ValueError(
            f"unknown staging {staging!r}; choose from {list(STAGINGS)}"
        )
    hazards: List[Hazard] = []

    if num_frames is not None:
        for i, op in enumerate(ops):
            for label, frame in (("src", op.src), ("dst", op.dst)):
                if not 0 <= frame < num_frames:
                    hazards.append(Hazard(
                        "out-of-range", i,
                        f"{label} frame {frame} outside [0, {num_frames}) "
                        f"(pid={op.pid})",
                    ))

    if trash_frame is not None:
        for i, op in enumerate(ops):
            if op.src == trash_frame and op.dst != trash_frame:
                hazards.append(Hazard(
                    "trash-misuse", i,
                    f"trash frame {trash_frame} sourced into real frame "
                    f"{op.dst} (pid={op.pid}) — reads garbage into live "
                    "data",
                ))
            elif op.dst == trash_frame and op.src != trash_frame:
                hazards.append(Hazard(
                    "trash-misuse", i,
                    f"payload of frame {op.src} (pid={op.pid}) written to "
                    f"trash frame {trash_frame} — the copy is lost",
                ))

    first_writer: dict = {}
    for i, op in enumerate(ops):
        if trash_frame is not None and op.dst == trash_frame:
            continue  # padding lanes may all target trash
        j = first_writer.get(op.dst)
        if j is not None and ops[j].src != op.src:
            hazards.append(Hazard(
                "dup-dst", i,
                f"frame {op.dst} written twice with different sources "
                f"({ops[j].src} by op#{j}, then {op.src}) — scatter write "
                "order is unspecified",
                other_index=j,
            ))
        elif j is None:
            first_writer[op.dst] = i

    if staging == "sequential":
        written: dict = {}
        for i, op in enumerate(ops):
            j = written.get(op.src)
            if j is not None:
                hazards.append(Hazard(
                    "raw-frame-reuse", i,
                    f"op reads frame {op.src} (pid={op.pid}) after op#{j} "
                    f"overwrote it (pid={ops[j].pid}) — sequential "
                    "execution copies the new payload; safe only under "
                    "gathers-first staging",
                    other_index=j,
                ))
            if not (trash_frame is not None and op.dst == trash_frame):
                written.setdefault(op.dst, i)
        return hazards

    return hazards


def check_plan(
    ops: Sequence[CopyOp],
    *,
    num_frames: Optional[int] = None,
    trash_frame: Optional[int] = None,
    staging: str = "gathers-first",
) -> None:
    """Like :func:`verify_plan` but raises :class:`PlanHazardError`."""
    hazards = verify_plan(
        ops, num_frames=num_frames, trash_frame=trash_frame, staging=staging
    )
    if hazards:
        raise PlanHazardError(hazards)
