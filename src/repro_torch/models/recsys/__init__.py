# RecSys: the embedding tables and bags (the hot path) + the BST ranking model.
