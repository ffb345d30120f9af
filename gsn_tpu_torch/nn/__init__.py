from .embedding import DiscreteEmbedding, MultiEmbedding
from .filters import EdgeMessageMLP, GSNLayer
from .mlp import MLP, choose_activation
from .models import GNNSubstructures, build_model

__all__ = ["DiscreteEmbedding", "MultiEmbedding", "EdgeMessageMLP",
           "GSNLayer", "MLP", "choose_activation", "GNNSubstructures",
           "build_model"]
