"""Command-line launchers (counterpart of ``repro.launch``): ``serve``
(train an LM briefly, fit the LSS head, serve it, optionally with online
index refresh, on one process or a fleet: ``--head lss-sharded
--coordinator --num-processes --process-id``) and ``train`` (train an LM
with checkpoints and auto-resume, on one device or on a (data, model)
mesh of ranks: ``--devices N --mesh DxM``); ``mesh`` makes the training
meshes."""
