"""The port's configs (counterparts of ``configs/``), each a Python file for
``python -m gecco_tpu_torch.train <file>``."""
