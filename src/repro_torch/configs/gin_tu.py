"""gin-tu [arXiv:1810.00826; paper].

n_layers=5 d_hidden=64 aggregator=sum eps=learnable.

Shape cells carry their own (n_nodes, n_edges, d_feat):
  full_graph_sm : cora-like      2,708 nodes / 10,556 edges / d=1,433 / 7 cls
  minibatch_lg  : reddit-like    232,965 nodes / 114.6M edges, sampled
                  batch_nodes=1,024 fanout 15-10 (2-hop neighbor sampler;
                  all 5 GIN layers run on the induced sampled subgraph)
  ogb_products  : 2,449,029 nodes / 61.86M edges / d=100 / 47 cls, full batch
  molecule      : 128 graphs x 30 nodes / 64 edges, graph classification
Counterpart of ``repro/configs/gin_tu.py``, field for field.
"""
from . import ArchBundle, ShapeSpec, register
from ..models.gnn import GINConfig

FULL = GINConfig(name="gin-tu", n_layers=5, d_in=1433, d_hidden=64, n_classes=7)
SMOKE = GINConfig(name="gin-tu-smoke", n_layers=2, d_in=16, d_hidden=8, n_classes=4)

SHAPES = (
    ShapeSpec("full_graph_sm", "fullbatch", n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    ShapeSpec("minibatch_lg", "sampled", n_nodes=232_965, n_edges=114_615_892,
              batch=1_024, d_feat=602),
    ShapeSpec("ogb_products", "fullbatch", n_nodes=2_449_029, n_edges=61_859_140,
              d_feat=100),
    ShapeSpec("molecule", "molecule", n_nodes=30, n_edges=64, batch=128, d_feat=16),
)
BUNDLE = register(ArchBundle("gin-tu", "gnn", FULL, SMOKE, SHAPES))
