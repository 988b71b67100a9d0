"""The paper's pipeline end to end: train the XC model, fit the LSS index
(Algorithm 1), serve with it (Algorithm 2) against the full head.

``python -m repro_torch.examples.quickstart`` (WIKI10 bench size) and
``python -m repro_torch.examples.train_wol`` (Delicious-200K at the
paper's width); both run on the GPU unless given ``--device cpu``.
"""
