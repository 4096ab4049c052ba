"""The partitioner's dominating-point state machine, one step per element."""
