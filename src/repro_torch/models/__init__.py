"""Models of the port: the GNN family (``models.gnn``), MIND
(``models.recsys``), the transformer family (``models.transformer``) and
the bridge that carries a reference parameter tree in and its gradients
out (``models.params``)."""
