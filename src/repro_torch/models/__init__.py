"""Models of the port: the recsys family (DCN-v2, DLRM, DIN, BST) and the
decoder-only transformer LM."""
