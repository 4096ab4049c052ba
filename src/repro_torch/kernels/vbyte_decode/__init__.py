"""Block Stream-VByte decode, plain and fused with NextGEQ."""
