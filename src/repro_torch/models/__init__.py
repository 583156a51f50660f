"""The LM zoo (the JAX package's ``models/``) in PyTorch: ``common``,
``layers``, ``moe``, ``ssm``, ``xlstm``, ``lm`` and ``graph_export``."""
