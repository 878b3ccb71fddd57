"""The port's agent-backed cluster backend (``fiber_tpu_torch/backends/
tpu.py``, a copy of the JAX package's): a ``sim:2`` cluster starts two
local host agents (``python -m fiber_tpu_torch.host_agent``, staging
under the port's root), and a pool over them maps CPU tensors to what a
local pool returns. The CLI's ``devices``, ``top`` and ``doctor`` then
read the live agents.

Starting the agents, staging the working tree to them and the workers'
torch import take about 20 s.
"""

import pytest
import torch

import fiber_tpu_torch
from fiber_tpu_torch import cli, config
from fiber_tpu_torch.backends import get_backend, reset_backends
from tests import _torch_pool_tasks as tasks


@pytest.fixture
def sim_cluster(monkeypatch):
    monkeypatch.setenv("FIBER_BACKEND", "tpu")
    old = config.get().tpu_hosts
    config.get().update(tpu_hosts="sim:2")
    reset_backends()
    try:
        yield
    finally:
        try:
            get_backend("tpu").shutdown_sim_cluster()
        finally:
            config.get().update(tpu_hosts=old)
            reset_backends()


def test_sim_cluster_pool_equals_the_local_pool(sim_cluster, monkeypatch,
                                                capsys):
    items = [(torch.arange(6, dtype=torch.float32) * x, x)
             for x in range(12)]
    with fiber_tpu_torch.Pool(2) as pool:
        got = pool.starmap(tasks.tensor_affine, items)
        backend = get_backend("tpu")
        hosts = backend._resolved_hosts_spec()
        assert len(hosts.split(",")) == 2
        assert [proc.args[1:3] for proc in backend._sim_agents] \
            == [["-m", "fiber_tpu_torch.host_agent"]] * 2
        capsys.readouterr()
        assert cli.main(["devices", "--hosts", hosts]) == 0
        devices = capsys.readouterr().out.splitlines()
        assert cli.main(["top", "--hosts", hosts, "--iterations", "1",
                         "--no-clear"]) == 0
        top = capsys.readouterr().out.splitlines()
        assert cli.main(["doctor", "--hosts", hosts,
                         "--timeout", "120"]) == 0
        doctor = capsys.readouterr().out
    monkeypatch.setenv("FIBER_BACKEND", "local")
    reset_backends()
    with fiber_tpu_torch.Pool(2) as pool:
        want = pool.starmap(tasks.tensor_affine, items)
    for (out, where), (ref, _) in zip(got, want):
        assert where == "cpu" and out.dtype == torch.float32
        assert torch.equal(out, ref)
    for host in hosts.split(","):
        assert any(row.startswith(host) for row in devices[1:])
        assert any(row.startswith(host) for row in top[2:])
        assert f"[ok  ] agent {host}" in doctor
