"""Training: losses through the model, Adam with the cosine schedule, the
finite guard, checkpoints and the Trainer (`factorvae_tpu/train/`)."""
