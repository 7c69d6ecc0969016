"""The LM of the port: every family of the JAX package's (``model.LM``),
their primitives (``layers``, ``attention``, ``moe``, ``ssm``) and the
carriers of parameters from the JAX package (``convert``)."""
