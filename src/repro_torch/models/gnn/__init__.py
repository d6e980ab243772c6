# GNN zoo of the port: SchNet, DimeNet, NequIP and EquiformerV2 (with the
# SO(3) machinery of so3.py). Message passing is index_add over edge
# indices, the same partitioned-CSR substrate the survey engine uses.
