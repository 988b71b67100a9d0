"""Command-line launchers (counterpart of ``repro.launch``): ``serve``
(train an LM briefly, fit the LSS head, serve it, optionally with online
index refresh) and ``train`` (train an LM with checkpoints and
auto-resume).  Single device: the multi-process flags of the JAX
launchers come with ROADMAP Queue 1 item 7."""
