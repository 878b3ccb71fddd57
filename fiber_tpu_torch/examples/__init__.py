"""Examples of the port that run as modules, so that pool workers and
ring ranks import their functions by reference:

    python -m fiber_tpu_torch.examples.poet_distributed [--device cpu]
    python -m fiber_tpu_torch.examples.ring_allreduce [--size 2]
    python -m fiber_tpu_torch.examples.pod_es_ring [--device cpu]
"""
