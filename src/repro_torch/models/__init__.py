"""Models of the port: the recsys family (DCN-v2, DLRM, DIN, BST), the
decoder-only transformer LM and the GNN family (GIN)."""
