"""PyTorch/CUDA port of :mod:`repro` (the JAX reference package).

The port mirrors ``repro``'s layout module for module, so each port file
sits at the path of its counterpart (``repro.core.sim`` ->
``repro_torch.core.sim``).  It imports ``torch`` and ``numpy`` only —
never ``jax`` and never a ``repro`` module; only the parity tests
(``tests/test_torch_*.py``) import both packages.

Entry points take ``device=None``, which means the CUDA card; without
one they raise (:func:`repro_torch.device.resolve_device`).  Callers
that want the CPU pass ``device="cpu"`` explicitly, as the tests do.
"""
