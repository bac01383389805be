"""Training: losses (``losses.py``) and the optimizer, train step and eval
step (``trainer.py``)."""
