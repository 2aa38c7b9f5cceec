from han_jax.nn.layers import GATConv, ConstAttention, SemanticAttention  # noqa: F401
from han_jax.nn.models import GAT, HAN, HANShared  # noqa: F401
from han_jax.nn import losses  # noqa: F401
