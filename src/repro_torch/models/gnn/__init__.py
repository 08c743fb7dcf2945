"""The GNN family on tensors: PNA, NequIP, MACE and DimeNet as
``nn.Module``s, their shared utilities (``common``) and the E(3) substrate
(``irreps``)."""
