"""Cross-group transactions: the port holds only the record format
(:mod:`~rdma_paxos_tpu_torch.txn.records`) so far; the commit lane and
the coordinator come with ROADMAP Queue 1, item 13."""
