# Model zoo of the port: the GNNs, SchNet first (models/gnn/). Message
# passing is index_add_ over edge indices, as the JAX package's is
# segment_sum; matrix products are torch.matmul.
