"""Training: loss and step, optimizers, gradient compression (the twin of
``repro.training``)."""
