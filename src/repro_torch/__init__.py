"""PyTorch/CUDA port of the SEIFER reproduction (the JAX package is ``repro``).

Same layout as the JAX package: ``core`` (partitioning, placement,
simulation, model zoo), ``api`` (``DeploymentSpec`` -> ``deploy``),
``dataplane`` (inter-stage codecs), ``cluster`` (control plane and the
pipelined serving engine), ``runtime`` (stage executors) and ``kernels``
(hand-written Hopper CUDA kernels beside their plain PyTorch versions).
It imports ``torch``, ``numpy`` and the standard library, and nothing of
JAX or of the ``repro`` package.
"""
