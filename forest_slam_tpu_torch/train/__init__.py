"""Training of the learned front end (port of train/): losses, synthetic
data, the trainer and distillation. ``python -m forest_slam_tpu_torch.train``
is the ``forest-slam train-frontend`` command, ``python -m
forest_slam_tpu_torch.train.distill`` the ``forest-slam distill-frontend``
one."""
