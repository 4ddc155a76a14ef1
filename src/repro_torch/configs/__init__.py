from repro_torch.configs.base import ANN_SHAPES, ANNConfig, ShapeSpec  # noqa: F401
