"""The LM of the port: the attention-and-SwiGLU families (``model.LM``),
their primitives (``layers``, ``attention``) and the carriers of parameters
from the JAX package (``convert``)."""
