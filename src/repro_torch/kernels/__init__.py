"""Kernels of the port: hand-written CUDA for Hopper (``csrc/*.cu``), each
beside its plain PyTorch version; :mod:`repro_torch.kernels.ops` is the
public, device-dispatching surface."""
