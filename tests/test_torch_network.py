"""The port's whole-network runner against the reference's: ResNet-18
(``shrink(8, 16)``), exact_opt/active schedules at P = 2048, the reference's
own weights carried across with ``params_from_jax``, the same numpy input,
every tensor compared (conv tolerance, fp32: 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.kernels import conv_network as jnet
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import plan as tplan
from repro_torch.kernels import conv_network as tnet

TOL = 1e-4


def _schedules(graph, plans):
    return {node.name: p.schedule for node, p in zip(graph.workload_nodes, plans)}


@pytest.fixture(scope="module")
def resnet():
    jg = JGraph.from_cnn("resnet18").shrink(8, 16)
    tg = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 16)
    jsched = _schedules(jg, jplan.plan_many(jg.workloads, 2048, "exact_opt", "active"))
    tsched = _schedules(tg, tplan.plan_many(tg.workloads, 2048, "exact_opt", "active"))
    jparams = jnet.init_network_params(jg, rng_seed=0)
    image = tg.tensors[tg.inputs[0]]            # 1 channel after shrink(8, 16)
    x = np.random.default_rng(0).standard_normal(
        (image.channels, image.h, image.w)).astype(np.float32)
    jvals = jnet.run_network_kernels(jg, jsched, jparams,
                                     inputs={jg.inputs[0]: jnp.asarray(x)})
    tparams = tnet.params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                   device="cpu")
    tvals = tnet.run_network_kernels(tg, tsched, tparams,
                                     inputs={tg.inputs[0]: torch.from_numpy(x)},
                                     device="cpu")
    return dict(jg=jg, tg=tg, jsched=jsched, tsched=tsched, tparams=tparams,
                x=x, jvals=jvals, tvals=tvals)


def test_schedules_match(resnet):
    assert list(resnet["tsched"]) == list(resnet["jsched"])
    for name, s in resnet["tsched"].items():
        j = resnet["jsched"][name]
        assert (s.m, s.n, s.controller.value) == (j.m, j.n, j.controller.value)


def test_every_tensor_matches_jax(resnet):
    jvals, tvals = resnet["jvals"], resnet["tvals"]
    assert set(tvals) == set(jvals) == set(resnet["tg"].tensors)
    for name, want in jvals.items():
        got = tvals[name]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_reference_walk_matches_runner(resnet):
    ref = tnet.run_network_reference(resnet["tg"], resnet["tparams"],
                                     inputs={resnet["tg"].inputs[0]:
                                             torch.from_numpy(resnet["x"])},
                                     device="cpu")
    for name, want in ref.items():
        torch.testing.assert_close(resnet["tvals"][name], want, rtol=TOL, atol=TOL)


def test_seeded_inputs_and_weights_are_reproducible():
    g = tplan.NetworkGraph.from_cnn("squeezenet").shrink(8, 16)
    sched = _schedules(g, tplan.plan_many(g.workloads, 2048, "paper_opt", "active"))
    p1 = tnet.init_network_params(g, seed=3, device="cpu")
    p2 = tnet.init_network_params(g, seed=3, device="cpu")
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    wl = g.workload_nodes[0].workload
    assert p1[g.workload_nodes[0].name].shape == (wl.cout, wl.cin, wl.k, wl.k)
    a = tnet.run_network_kernels(g, sched, p1, seed=5, device="cpu")
    b = tnet.run_network_kernels(g, sched, p1, seed=5, device="cpu")
    out = g.outputs[0]
    assert torch.equal(a[out], b[out])
    assert a[out].shape == (g.tensors[out].channels, 8, 8)


def _corrupt(case):
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 16)
    sched = _schedules(g, tplan.plan_many(g.workloads, 2048, "exact_opt", "active"))
    params = tnet.init_network_params(g, device="cpu")
    first = g.workload_nodes[0].name
    if case == "no schedule":
        del sched[first]
    elif case == "no weights":
        del params[first]
    elif case == "weight shape":
        params[first] = params[first][:1]
    elif case == "grouped":
        g = tplan.NetworkGraph.from_cnn("mobilenet").shrink(8, 16)
        sched = _schedules(g, tplan.plan_many(g.workloads, 2048, "exact_opt", "active"))
        params = tnet.init_network_params(g, device="cpu")
    elif case == "not same-padded":       # squeezenet's unpadded 7x7 stem
        g = tplan.NetworkGraph.from_cnn("squeezenet")
        sched = _schedules(g, tplan.plan_many(g.workloads, 2048, "exact_opt", "active"))
        params = {n.name: torch.zeros(n.workload.cout, n.workload.cin,
                                      n.workload.k, n.workload.k)
                  for n in g.workload_nodes}
    return g, sched, params


@pytest.mark.parametrize("case,match", [
    ("no schedule", "has no schedule"), ("no weights", "has no weights"),
    ("weight shape", "weights shaped"), ("grouped", "dense convs only"),
    ("input shape", "input tensor"),
    ("not same-padded", "not 'same'-padded")])
def test_bad_plans_are_rejected_before_the_first_launch(case, match, monkeypatch):
    launched = []
    monkeypatch.setattr(tnet, "conv2d_psum", lambda *a, **k: launched.append(1))
    g, sched, params = _corrupt(case)
    inputs = {g.inputs[0]: torch.zeros(3, 8, 8)} if case == "input shape" else None
    with pytest.raises(ValueError, match=match):
        tnet.run_network_kernels(g, sched, params, inputs=inputs, device="cpu")
    assert launched == []


def test_cuda_without_a_gpu_raises():
    """Asking for the card where there is none raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 16)
    sched = _schedules(g, tplan.plan_many(g.workloads, 2048, "exact_opt", "active"))
    params = tnet.init_network_params(g, device="cpu")
    for call in (lambda: tnet.init_network_params(g, device="cuda"),
                 lambda: tnet.params_from_jax({}, device="cuda"),
                 lambda: tnet.run_network_kernels(g, sched, params, device="cuda"),
                 lambda: tnet.run_network_reference(g, params, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
