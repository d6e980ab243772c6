# GNN zoo of the port: SchNet so far. Message passing is index_add over
# edge indices, the same partitioned-CSR substrate the survey engine uses.
