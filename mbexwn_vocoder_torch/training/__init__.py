"""Training-side code of the port.  Only the synthetic eval corpus is ported
so far (`synthetic.py`); the trainer is ROADMAP.md queue 1, item 12."""
