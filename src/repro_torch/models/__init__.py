# Model zoo of the port: the GNNs, SchNet first (models/gnn/), and the
# decoder-only LMs (transformer.py, moe.py). Message passing is index_add_
# over edge indices, as the JAX package's is segment_sum; matrix products
# are torch.matmul.
