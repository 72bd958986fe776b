"""Training-side code of the port: the synthetic corpus (`synthetic.py`),
the loss-weight schedules, the losses and the trainer (one training step;
the training loop, data loader and CLI are ROADMAP.md queue 1, item 12b).
Importing the package imports none of them."""
