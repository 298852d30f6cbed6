"""Mesh solves over several cards (counterpart of hprlp_tpu/parallel):
process groups and the launcher (distributed.py, worker.py) and the
column sharding of a single LP's matrices (sharded.py)."""
