"""Trainers of the port (counterparts of ``sessionsimilaritysearch_tpu.training``):
the pretrainer, the session / subsession / joint trainers, the similarity
fine-tuner, their losses, the train state and the training loop."""
from sessionsimilaritysearch_tpu_torch.training import losses  # noqa: F401
