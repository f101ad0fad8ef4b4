"""Training of the learned front end (port of train/): losses, synthetic
data and the trainer. ``python -m forest_slam_tpu_torch.train`` is the
``forest-slam train-frontend`` command."""
