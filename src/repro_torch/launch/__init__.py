"""Launch layer of the port: meshes (``mesh``), sharding rules and
layouts (``sharding``), dry-run cells (``cells``), the dry run
(``python -m repro_torch.launch.dryrun``) and the trainer
(``python -m repro_torch.launch.train``)."""
