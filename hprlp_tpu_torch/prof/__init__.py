"""The port's measurement entry points: the SpMV variant studies
(prof_*.py, counterparts of benchmarks/prof_*.py), their shared path
(study.py), timing and byte model (timing.py), each mesh rank's memory
through the share ingest (share_ingest.py), and the benchmarks' seeded
LP generators (problems.py).  They need a CUDA device to run; importing
them needs none.
"""
