"""Models of the port: the GNN family (``models.gnn``)."""
