"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Sources live under ``csrc/`` and are compiled by
:mod:`repro_torch.kernels.build` at first use, never at import."""
