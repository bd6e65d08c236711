"""The benchmark of ``rdma_paxos_tpu_torch`` on one NVIDIA H100:
``python3 -m paxbench --workload <config>.<traffic> --seed N --seconds S
--trace 0|1`` (see ``run.py``). Imports neither JAX nor the JAX
package."""
