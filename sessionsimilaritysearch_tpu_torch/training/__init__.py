"""Trainers of the port (counterparts of ``sessionsimilaritysearch_tpu.training``):
so far the pretrainer, its losses, the train state and the training loop."""
