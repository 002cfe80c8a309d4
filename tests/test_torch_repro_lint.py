"""The port's repro-lint against the JAX package's, and its torch roots.

Every snippet of ``tests/test_repro_lint.py`` (copied here, keyed by the
test that uses it) gives the same ``(rule, line, col)`` findings through
both packages' ``lint_source``.  Then the port's tracers as roots: a
host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``int(t)``) or an
``if`` on a tensor inside a ``torch.compile`` function, a function
registered at ``torch.compile(f)`` or ``make_graphed_callables``, and a
``with torch.cuda.graph(...)`` block is flagged; the same code outside a
root, or before the capture block, is not; suppressions work as in JAX.
Last, the port's tree is clean under the port's lint, through the CLI
too.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.analysis import repro_lint as jax_lint  # noqa: E402
from repro_torch.analysis import repro_lint as lint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sources ``tests/test_repro_lint.py`` lints, by the test that lints each
SNIPPETS = {
    "TestHostSync.test_item_in_jit_root": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    return x.sum().item()\n'
    ),
    "TestHostSync.test_item_in_reachable_helper": (
        'import jax\n'
        'def helper(x):\n'
        '    return x.item()\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    return helper(x)\n'
    ),
    "TestHostSync.test_int_cast_on_traced": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    return int(x)\n'
    ),
    "TestHostSync.test_np_asarray_on_traced": (
        'import jax\n'
        'import numpy as np\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    y = np.asarray(x)\n'
        '    return y\n'
    ),
    "TestHostSync.test_assert_on_traced_value": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    assert x > 0\n'
        '    return x\n'
    ),
    "TestHostSync.test_negative_item_outside_jit": (
        'def host_only(x):\n'
        '    return x.item()\n'
    ),
    "TestHostSync.test_negative_free_call_result_is_host": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x, make_mask):\n'
        '    m = lookup_mask()\n'
        '    if m is not None:\n'
        '        x = x + 1\n'
        '    return x\n'
        'def lookup_mask():\n'
        '    return None\n'
    ),
    "TestHostSync.test_negative_int_on_host_value": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    n = int(x.shape[0])\n'
        '    return x + n\n'
    ),
    "TestTracedControlFlow.test_if_on_traced": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    if x > 0:\n'
        '        return x\n'
        '    return -x\n'
    ),
    "TestTracedControlFlow.test_while_on_traced": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    while x > 0:\n'
        '        x = x - 1\n'
        '    return x\n'
    ),
    "TestTracedControlFlow.test_negative_branch_on_static_arg": (
        'import functools\n'
        'import jax\n'
        "@functools.partial(jax.jit, static_argnames=('mode',))\n"
        'def f(x, mode):\n'
        "    if mode == 'fast':\n"
        '        return x * 2\n'
        '    return x\n'
    ),
    "TestTracedControlFlow.test_negative_branch_on_shape": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x):\n'
        '    if x.ndim == 2:\n'
        '        return x.sum(axis=1)\n'
        '    return x\n'
    ),
    "TestTracedControlFlow.test_negative_membership_test": (
        'import jax\n'
        '@jax.jit\n'
        'def f(x, names):\n'
        '    if x is None:\n'
        '        return names\n'
        '    return x\n'
    ),
    "TestUnstableStatic.test_static_name_missing_from_signature": (
        'import functools\n'
        'import jax\n'
        "@functools.partial(jax.jit, static_argnames=('mode', 'oops'))\n"
        'def f(x, mode):\n'
        '    return x\n'
    ),
    "TestUnstableStatic.test_static_with_mutable_default": (
        'import functools\n'
        'import jax\n'
        "@functools.partial(jax.jit, static_argnames=('opts',))\n"
        'def f(x, opts=[]):\n'
        '    return x\n'
    ),
    "TestUnstableStatic.test_negative_hashable_static": (
        'import functools\n'
        'import jax\n'
        "@functools.partial(jax.jit, static_argnames=('mode',))\n"
        "def f(x, mode='fast'):\n"
        '    return x\n'
    ),
    "TestUnstableStatic.test_static_argnums_maps_to_params": (
        'import functools\n'
        'import jax\n'
        '@functools.partial(jax.jit, static_argnums=(1,))\n'
        'def f(x, opts={}):\n'
        '    return x\n'
    ),
    "TestHostStateMutation.test_self_attr_write_in_jit_method": (
        'import jax\n'
        'class Engine:\n'
        '    @jax.jit\n'
        '    def step(self, x):\n'
        '        self.counter = self.counter + 1\n'
        '        return x\n'
    ),
    "TestHostStateMutation.test_self_subscript_write": (
        'import jax\n'
        'class Engine:\n'
        '    @jax.jit\n'
        '    def step(self, x):\n'
        '        self.cache[0] = x\n'
        '        return x\n'
    ),
    "TestHostStateMutation.test_negative_local_assignment": (
        'import jax\n'
        'class Engine:\n'
        '    @jax.jit\n'
        '    def step(self, x):\n'
        '        y = x + 1\n'
        '        return y\n'
    ),
    "TestHostStateMutation.test_negative_self_write_outside_jit": (
        'class Engine:\n'
        '    def host_step(self, x):\n'
        '        self.counter += 1\n'
        '        return x\n'
    ),
    "TestRemovedPoolQos.test_pool_qos_read": (
        'def f(pool):\n'
        '    return pool.qos\n'
    ),
    "TestRemovedPoolQos.test_self_pool_qos": (
        'class S:\n'
        '    def f(self):\n'
        '        self.pool.qos.note_interval()\n'
    ),
    "TestRemovedPoolQos.test_negative_other_qos_attrs": (
        'def f(cfg, engine):\n'
        '    return cfg.qos, engine.qos\n'
    ),
    "TestMissingTenant.test_allocate_without_tenant_in_tenant_scope": (
        'def place(pool, tenant_ids):\n'
        '    for tid in tenant_ids:\n'
        '        pool.allocate(1)\n'
    ),
    "TestMissingTenant.test_try_allocate_many_without_tenant": (
        'def place(pool, tids):\n'
        '    pool.try_allocate_many(pids)\n'
    ),
    "TestMissingTenant.test_negative_tenant_kwarg": (
        'def place(pool, tids):\n'
        '    pool.try_allocate_many(pids, tenants=tids)\n'
    ),
    "TestMissingTenant.test_negative_positional_arity_covers_tenant": (
        'def place(pool, tid):\n'
        '    pool.allocate(pid, ptype, flags, tid)\n'
    ),
    "TestMissingTenant.test_negative_no_tenant_context": (
        'def warmup(pool):\n'
        '    pool.allocate(1)\n'
    ),
    "TestAssertHostSync.test_assert_item": (
        'def check(x):\n'
        '    assert x.sum().item() == 0\n'
    ),
    "TestAssertHostSync.test_negative_plain_assert": (
        'def check(n):\n'
        '    assert n == 0\n'
    ),
    "TestSuppression.test_inline_suppression": (
        'def check(x):\n'
        '    assert x.sum().item() == 0  # repro-lint: disable=assert-host-sync\n'
    ),
    "TestSuppression.test_line_above_suppression": (
        'def check(x):\n'
        '    # repro-lint: disable=assert-host-sync (intended)\n'
        '    assert x.sum().item() == 0\n'
    ),
    "TestSuppression.test_bare_disable_suppresses_all": (
        'def check(x):\n'
        '    assert x.sum().item() == 0  # repro-lint: disable\n'
    ),
    "TestSuppression.test_wrong_rule_does_not_suppress": (
        'def check(x):\n'
        '    assert x.sum().item() == 0  # repro-lint: disable=jit-host-sync\n'
    ),
    "TestHarness.test_finding_format": (
        'def f(pool):\n'
        '    return pool.qos\n'
    ),
    "TestHarness.test_syntax_error_is_a_finding": (
        'def f(:\n'
    ),
}


def keys(findings):
    return [(f.rule, f.line, f.col) for f in findings]


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_match_jax(name):
    src = SNIPPETS[name]
    assert keys(lint.lint_source(src)) == keys(jax_lint.lint_source(src))


def test_rule_catalogue_matches_jax():
    assert set(lint.RULES) == set(jax_lint.RULES)


# --------------------------------------------------------------------- #
# the port's roots: torch.compile and CUDA-graph capture
# --------------------------------------------------------------------- #
# each hazard as the statement(s) that use the tensor ``x``; ``line`` is
# the hazard's line within them
HAZARDS = {
    "item": ("n = x.sum().item()\n", "jit-host-sync"),
    "tolist": ("n = x.tolist()\n", "jit-host-sync"),
    "cpu": ("n = x.cpu()\n", "jit-host-sync"),
    "int": ("n = int(x)\n", "jit-host-sync"),
    "if": ("if x.sum() > 0:\n    x = x + 1\n", "jit-traced-control-flow"),
}


def indent(code, n):
    return "".join(" " * n + line + "\n" for line in code.splitlines())


def compiled(code):
    """``code`` in a ``torch.compile`` function; the hazard on line 4."""
    return ("import torch\n@torch.compile\ndef f(x):\n" + indent(code, 4)
            + "    return x\n")


def registered(code):
    """``code`` in a function registered at ``torch.compile(f)``; line 3."""
    return ("import torch\ndef f(x):\n" + indent(code, 4)
            + "    return x\ng = torch.compile(f, mode='reduce-overhead')\n")


def graphed(code):
    """``code`` in a function given to ``make_graphed_callables``; line 3."""
    return ("import torch\ndef f(x):\n" + indent(code, 4)
            + "    return x\nfs = torch.cuda.make_graphed_callables((f,), ((x,),))\n")


def captured(code):
    """``code`` in a ``with torch.cuda.graph`` block; line 5."""
    return ("import torch\ndef capture(g, x):\n    y = x * 2\n"
            "    with torch.cuda.graph(g):\n" + indent(code, 8) + "    return x\n")


def plain(code):
    """``code`` in a plain function: no root; line 3."""
    return "import torch\ndef f(x):\n" + indent(code, 4) + "    return x\n"


def before_capture(code):
    """``code`` before the capture block of a capturing function."""
    return ("import torch\ndef capture(g, x):\n" + indent(code, 4)
            + "    with torch.cuda.graph(g):\n        y = x * 2\n    return y\n")


ROOTS = {"compile": (compiled, 4), "registered": (registered, 3),
         "graphed": (graphed, 3), "graph_block": (captured, 5)}


@pytest.mark.parametrize("hazard", sorted(HAZARDS))
@pytest.mark.parametrize("root", sorted(ROOTS))
def test_hazard_in_torch_root_is_flagged(root, hazard):
    wrap, line = ROOTS[root]
    code, rule = HAZARDS[hazard]
    assert [(f.rule, f.line) for f in lint.lint_source(wrap(code))] == [(rule, line)]


@pytest.mark.parametrize("hazard", sorted(HAZARDS))
@pytest.mark.parametrize("wrap", [plain, before_capture], ids=["plain", "before_capture"])
def test_hazard_outside_a_root_is_not_flagged(wrap, hazard):
    assert lint.lint_source(wrap(HAZARDS[hazard][0])) == []


def test_helper_called_in_a_capture_is_checked():
    src = ("import torch\n"
           "def helper(x):\n"
           "    return x.tolist()\n"
           "def capture(g, x):\n"
           "    with torch.cuda.graph(g):\n"
           "        helper(x)\n")
    assert keys(lint.lint_source(src)) == [("jit-host-sync", 3, 11)]


def test_host_state_written_in_a_capture():
    src = ("import torch\n"
           "class Runner:\n"
           "    def capture(self, g, x):\n"
           "        self.before = x\n"
           "        with torch.cuda.graph(g):\n"
           "            self.out = x * 2\n")
    assert keys(lint.lint_source(src)) == [("jit-host-state-mutation", 6, 12)]


def test_host_values_in_a_root_are_not_flagged():
    # shapes, len() and is-None tests stay host values under every tracer
    src = ("import torch\n"
           "import torch.nn.functional as F\n"
           "@torch.compile\n"
           "def f(x, mask):\n"
           "    n = int(x.shape[0])\n"
           "    if mask is not None:\n"
           "        x = x + mask\n"
           "    for i in range(len(x.shape)):\n"
           "        x = F.relu(x)\n"
           "    return x + n\n")
    assert lint.lint_source(src) == []


def test_torch_calls_propagate_taint():
    src = ("import torch\n"
           "import torch.nn.functional as F\n"
           "@torch.compile\n"
           "def f(x):\n"
           "    y = F.softmax(torch.matmul(x, x), dim=-1)\n"
           "    while y.max() > 0.5:\n"
           "        y = y / 2\n"
           "    return y\n")
    assert keys(lint.lint_source(src)) == [("jit-traced-control-flow", 6, 4)]


def test_re_compile_is_no_root():
    src = "import re\n@re.compile\ndef f(x):\n    return x.item()\n"
    assert lint.lint_source(src) == []


@pytest.mark.parametrize("root", sorted(ROOTS))
def test_suppression_in_torch_roots(root):
    wrap, line = ROOTS[root]
    inline = wrap("n = x.item()  # repro-lint: disable=jit-host-sync\n")
    assert lint.lint_source(inline) == []
    above = wrap("# repro-lint: disable=jit-host-sync (measured once)\nn = x.item()\n")
    assert lint.lint_source(above) == []
    other = wrap("n = x.item()  # repro-lint: disable=missing-tenant\n")
    assert [f.rule for f in lint.lint_source(other)] == ["jit-host-sync"]


# --------------------------------------------------------------------- #
# the port's tree
# --------------------------------------------------------------------- #
def test_port_tree_is_clean():
    roots = [os.path.join(REPO, p) for p in ("src/repro_torch", "chip_smoke.py", "tools")]
    findings = lint.lint_paths(roots)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_module_entrypoint():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-W", "error", "-m", "repro_torch.analysis.repro_lint",
         "src/repro_torch", "chip_smoke.py", "tools"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stderr


def test_cli_flags_a_dirty_file(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\n@torch.compile\ndef f(x):\n    return x.item()\n")
    assert lint.main([str(dirty)]) == 1
    assert "jit-host-sync" in capsys.readouterr().out
