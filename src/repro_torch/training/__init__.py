"""Single-device training: optimizers (``optim``) and the fault-tolerant
``Trainer`` (``loop``)."""
