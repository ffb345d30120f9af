from .dgn import DGNConfig, DGNNet, build_dgn_model, compute_avg_d
from .embedding import DiscreteEmbedding, MultiEmbedding
from .filters import EdgeMessageMLP, GSNLayer
from .mlp import MLP, choose_activation
from .models import GNNSubstructures, NodeDropout, build_model

__all__ = ["DGNConfig", "DGNNet", "build_dgn_model", "compute_avg_d",
           "NodeDropout", "DiscreteEmbedding", "MultiEmbedding", "EdgeMessageMLP",
           "GSNLayer", "MLP", "choose_activation", "GNNSubstructures",
           "build_model"]
