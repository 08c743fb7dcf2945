"""The training substrate of the port: optimizers (``optim``), gradient
codecs (``compress``), deterministic data (``data``), atomic checkpoints
(``checkpoint``), the step and loop (``loop``) and restart glue
(``elastic``)."""
