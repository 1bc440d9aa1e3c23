"""The paper's own GNN training configurations (§6.1).

2-hop random neighbor sampling with fan-outs (25, 10), hidden dim 256,
batch size 8000, node classification; datasets from Table 2 (registered as
profiles in repro_torch.graph.csr.PAPER_DATASETS, instantiated
synthetically via synthetic_instance()).
"""
from repro_torch.models.gnn import GNNConfig

GRAPHSAGE = GNNConfig(name="graphsage-2hop", model="sage", hidden=256,
                      fanouts=(25, 10), batch_size=8000)
GCN = GNNConfig(name="gcn-2hop", model="gcn", hidden=256,
                fanouts=(25, 10), batch_size=8000)

# small variants for examples and tests
GRAPHSAGE_SMALL = GNNConfig(name="graphsage-small", model="sage", hidden=64,
                            fanouts=(10, 5), batch_size=512)
