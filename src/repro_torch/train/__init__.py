"""Training runtime of the port: step factory, telemetry, trainer loop."""
from .step import loss_and_grads, make_eval_step, make_train_step

__all__ = ["loss_and_grads", "make_train_step", "make_eval_step"]
