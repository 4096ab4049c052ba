"""Models of the port: the recsys family (DCN-v2 and DLRM so far)."""
