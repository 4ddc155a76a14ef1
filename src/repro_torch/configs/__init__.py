from repro_torch.configs.base import (  # noqa: F401
    ANN_SHAPES, ANNConfig, GNN_N_CLASSES, GNN_SHAPES, GNNConfig, LM_SHAPES,
    MoEConfig, RECSYS_SHAPES, RecsysConfig, ShapeSpec, TransformerConfig,
    get_arch, get_reduced, list_archs, shapes_for,
)
