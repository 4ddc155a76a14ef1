"""Training: the trainer (``trainer.py``) and checkpoints
(``checkpoint.py``), the port's copies of the reference's ``train/``."""
