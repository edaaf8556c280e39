"""Training: the train step (loss, gradients, AdamW), the optimizer and
the checkpoint; and the prefill and serve step builders."""
