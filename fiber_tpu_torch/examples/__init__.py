"""The JAX package's example programs, ported. Each runs as a module (so
that pool workers and ring ranks import its functions by reference), has
a ``main(argv=None)`` that tests and ``chip_smoke.py`` call in-process,
and keeps its JAX original's flags, defaults and output lines. Every
program that touches a device takes ``--device`` (the card unless it is
``cpu``; without a card the program raises unless it is given ``--device
cpu``):

    python -m fiber_tpu_torch.examples.es_cartpole [--pop 1024 --gens 50]
        [--algo es|pgpe|cma|fullcma] [--optimizer adam] [--fused]
    python -m fiber_tpu_torch.examples.poet_cartpole [--env hill|biped]
    python -m fiber_tpu_torch.examples.long_context_lm [--attention flash]
    python -m fiber_tpu_torch.examples.tune_es [--pops 2048,4096]
    python -m fiber_tpu_torch.examples.es_conv_pixels
    python -m fiber_tpu_torch.examples.novelty_maze
    python -m fiber_tpu_torch.examples.map_elites_maze
    python -m fiber_tpu_torch.examples.es_pool_gym [--workers 4]
    python -m fiber_tpu_torch.examples.pi_estimation [--device-map]
    python -m fiber_tpu_torch.examples.parzen_estimation [--device-map]
    python -m fiber_tpu_torch.examples.pod_es_ring [--sim 2] [--size 2]
    python -m fiber_tpu_torch.examples.poet_distributed
    python -m fiber_tpu_torch.examples.ring_allreduce [--size 2]

``pi_estimation`` and ``parzen_estimation`` name the JAX programs'
``--device`` switch (run the tensor variant on the device) ``--device-map``.
The host-only tours are the JAX programs with the package renamed, and
take no ``--device``: ``basics``, ``shared_data``, ``async_manager``,
``line_count``, ``bench_queue``, ``bench_frameworks`` and
``es_pool_simple``.
"""
