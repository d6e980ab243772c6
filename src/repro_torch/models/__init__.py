# Model zoo of the port: the GNNs, SchNet first (models/gnn/), the
# decoder-only LMs (transformer.py, moe.py) and recsys's BST with its
# embedding tables and bags (models/recsys/). Message passing is index_add_
# over edge indices, as the JAX package's is segment_sum; matrix products
# are torch.matmul.
