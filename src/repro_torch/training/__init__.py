"""Training: walk and token pipelines, optimizers, the train step, the
fault-tolerant trainer and checkpoints (the port of ``repro.training``)."""
