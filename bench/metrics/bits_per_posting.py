"""The paper's space measure: the built index's docID bits per posting
(``PartitionedIndex.bits_per_int()``)."""


def read(ctx):
    return ctx.facts.get("bits_per_posting")
