"""Data-parallel training over a device mesh: the port's mesh-global
BatchNorm against one BatchNorm over the whole batch, its mesh train and
finetune steps over ``["cpu"] * 2`` against its one-device step and
against the JAX package's steps jitted over a 2-device virtual mesh
(``replicate`` + ``shard_batch``, as __graft_entry__.dryrun_multichip
does), the replicas' bits, and the reductions' failure modes.

The oracle is tests/test_torch_train.py's module fixture (the JAX
package's build_train_env at batch 2, 32 rays x 8 samples, 256 + 64
points, 128^2 maps, with the redrawn density and offset heads), and JAX's
own uniform draws go to the port as ``t_rand``. Against JAX the
tolerances are test_train_steps_match_jax's (its docstring gives the
reasons): losses rtol 1e-5, running statistics rtol 1e-4, the parameters
by the STEP_SHARE rule. Against the port's one-device step only the
summation order differs: losses rtol 1e-6, running statistics 1e-5, the
parameters by the first step's share rule (Adam's first step moves an
element whose gradient is ~0 by +-lr either way).
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_train import (  # noqa: F401  (env, _torch_threads: fixtures)
    N_SAMPLES, STEP_SHARE, STEP_TOL, _check_state, _jbatch, _np,
    _param_names, _t_rand, _tbatch, _torch_threads, env)

LRS = (1e-3, 1e-4)


def _jax_mesh():
    from avatarcap_tpu.parallel.mesh import make_mesh
    return make_mesh(jax.devices()[:2])


def _mesh(n=2):
    from avatarcap_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(["cpu"] * n)


def _trainer(env, mesh=None):
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    return AvatarTrainer(statics=env["tstatics"], net_ckpt_dir="unused",
                         n_samples=N_SAMPLES, device="cpu", mesh=mesh)


def _run(mesh, fn):
    """fn(rank) on every replica of the mesh (ReplicaWorkers.run)."""
    from avatarcap_tpu_torch.parallel.mesh import ReplicaWorkers
    with ReplicaWorkers(mesh) as workers:
        return workers.run(fn)


def _bn_case(kind, seed=0):
    """A BatchNorm of the port with drawn affine parameters and running
    statistics, and an input whose items differ in mean and scale (as the
    U-Net's deepest blocks see: 2 x 2 maps)."""
    from avatarcap_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d
    rs = np.random.RandomState(seed)
    if kind == "1d":
        bn = BatchNorm1d(16)
        shape = (8, 16)
    else:
        bn = BatchNorm2d(8, affine=False)
        shape = (4, 8, 2, 2)
    with torch.no_grad():
        if bn.affine:
            bn.weight.copy_(torch.from_numpy(
                rs.uniform(0.5, 1.5, 16).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(
                rs.uniform(-0.5, 0.5, 16).astype(np.float32)))
        bn.running_mean.uniform_(-0.1, 0.1)
        bn.running_var.uniform_(0.9, 1.1)
    lead = (shape[0],) + (1,) * (len(shape) - 1)
    x = (rs.standard_normal(shape) * rs.uniform(0.5, 3.0, lead)
         + rs.uniform(-2.0, 2.0, lead)).astype(np.float32)
    g = rs.standard_normal(shape).astype(np.float32)
    return bn.train(), torch.from_numpy(x), torch.from_numpy(g)


def _check_bn(ref, ref_x, reps, xs, outs, y, tol=1e-6):
    """The replicas' outputs, running statistics (bit-equal on every
    replica) and input / weight gradients against one BatchNorm over the
    whole batch."""
    np.testing.assert_allclose(torch.cat(outs).detach().numpy(),
                               y.detach().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(torch.cat([x.grad for x in xs]).numpy(),
                               ref_x.grad.numpy(), rtol=tol, atol=tol)
    for name in ("running_mean", "running_var"):
        got = getattr(reps[0], name)
        assert all(torch.equal(getattr(r, name), got) for r in reps), name
        np.testing.assert_allclose(got.numpy(), getattr(ref, name).numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    if ref.affine:
        for name in ("weight", "bias"):
            got = sum(getattr(r, name).grad for r in reps)
            np.testing.assert_allclose(
                got.numpy(), getattr(ref, name).grad.numpy(), rtol=tol,
                atol=tol, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_mesh_batchnorm_is_whole_batch(kind, n):
    """BatchNorm1d / 2d in replicas over ["cpu"] * n (one backward over
    the sum of the replicas' losses) against one BatchNorm on the
    concatenated batch: outputs, running statistics and gradients within
    1e-6. The same replicas with per-replica statistics (each BatchNorm
    called outside a mesh) fail the same check."""
    import copy
    bn, x, g = _bn_case(kind)
    ref = copy.deepcopy(bn)
    ref_x = x.clone().requires_grad_()
    y = ref(ref_x)
    (y * g).sum().backward()
    gs = g.chunk(n)

    def replicas():
        reps = [copy.deepcopy(bn) for _ in range(n)]
        xs = [c.clone().requires_grad_() for c in x.chunk(n)]
        return reps, xs

    reps, xs = replicas()
    outs = _run(_mesh(n), lambda r: reps[r](xs[r]))
    sum((o * gg).sum() for o, gg in zip(outs, gs)).backward()
    _check_bn(ref, ref_x, reps, xs, outs, y)

    reps, xs = replicas()
    outs = [rep(xr) for rep, xr in zip(reps, xs)]
    sum((o * gg).sum() for o, gg in zip(outs, gs)).backward()
    with pytest.raises(AssertionError):
        _check_bn(ref, ref_x, reps, xs, outs, y)


def test_all_reduce_order_and_gradient():
    """sum_to_first adds in device order onto the first device (bit-equal
    to the left fold), all_reduce copies the sum to every device, and
    autograd runs back through both."""
    from avatarcap_tpu_torch.parallel.mesh import all_reduce, sum_to_first
    mesh = _mesh(3)
    rs = np.random.RandomState(1)
    ts = [torch.from_numpy(rs.standard_normal(1000).astype(np.float32)
                           * 10.0 ** k).requires_grad_() for k in range(3)]
    s = sum_to_first(mesh, ts)
    assert torch.equal(s, (ts[0] + ts[1]) + ts[2])
    outs = all_reduce(mesh, ts)
    assert len(outs) == 3 and all(torch.equal(o, s) for o in outs)
    sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
    for t in ts:
        np.testing.assert_array_equal(t.grad.numpy(), np.full(1000, 6.0))
    with pytest.raises(ValueError, match="tensors for a mesh"):
        sum_to_first(mesh, ts[:2])


def _in_thread(fn, timeout=60.0):
    """fn() in a thread joined with a timeout: (finished, result or
    exception)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:       # handed to the test's thread
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout)
    return not t.is_alive(), out


def test_replica_failures_raise_without_hanging():
    """A replica that raises, or that makes fewer reductions than the
    others, fails the run in the caller's thread; no replica is left
    waiting."""
    from avatarcap_tpu_torch.parallel.mesh import replica_group
    mesh = _mesh(3)

    def raising(rank):
        group, r = replica_group()
        group.all_reduce(r, torch.ones(2))
        if rank == 1:
            raise KeyError("replica 1")
        group.all_reduce(r, torch.ones(2))

    def fewer(rank):
        group, r = replica_group()
        for _ in range(3 if rank else 2):
            group.all_reduce(r, torch.ones(2))

    def shapes(rank):
        group, r = replica_group()
        group.all_reduce(r, torch.ones(2 + rank))

    for fn, err, match in ((raising, KeyError, "replica 1"),
                           (fewer, RuntimeError, "numbers of"),
                           (shapes, ValueError, "shapes")):
        done, out = _in_thread(lambda: _run(mesh, fn))
        assert done, fn.__name__
        assert isinstance(out.get("error"), err), (fn.__name__, out)
        assert match in str(out["error"])
    assert replica_group() is None


def test_replica_workers_keep_their_threads():
    """ReplicaWorkers runs each rank on the same host thread call after
    call (the steps keep theirs), with the caller's grad mode and no
    group left behind; close ends the threads."""
    from avatarcap_tpu_torch.parallel.mesh import (ReplicaWorkers,
                                                   replica_group)
    workers = ReplicaWorkers(_mesh(3))

    def fn(rank):
        group, r = replica_group()
        assert r == rank and group.mesh == workers.mesh
        return threading.get_ident(), torch.is_grad_enabled()

    first = workers.run(fn)
    with torch.no_grad():
        second = workers.run(fn)
    assert [t for t, _ in first] == [t for t, _ in second]
    assert len({t for t, _ in first}) == 3
    assert threading.get_ident() not in {t for t, _ in first}
    assert [g for _, g in first] == [True] * 3
    assert [g for _, g in second] == [False] * 3
    idents = {t for t, _ in first}
    threads = [t for t in threading.enumerate() if t.ident in idents]
    assert len(threads) == 3
    workers.close()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)


def test_replica_reductions_under_thread_switching():
    """16 replicas (more than the cores) through 200 reductions each with
    the interpreter switching threads every microsecond: every round's
    sum is that round's, with each replica's count, in device order."""
    import sys
    from avatarcap_tpu_torch.parallel.mesh import replica_group
    n, rounds = 16, 200
    mesh = _mesh(n)

    def fn(rank):
        group, r = replica_group()
        bad = 0
        for i in range(rounds):
            s, counts = group.all_reduce(
                r, torch.full((3,), float(i * n + rank)), rank)
            bad += int(not torch.equal(
                s, torch.full((3,), float(i * n * n + n * (n - 1) // 2))))
            bad += int(counts != tuple(range(n)))
        return bad

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done, out = _in_thread(lambda: _run(mesh, fn), timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert done and "error" not in out, out
    assert out["value"] == [0] * n


def _state_equal(a, b):
    """Parameters, BatchNorm statistics and Adam moments bit-equal."""
    sa, sb = a[0].state_dict(), b[0].state_dict()
    assert sa.keys() == sb.keys()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    bad += [(g, k) for g in a[1] for k in ("mu", "nu")
            if not torch.equal(getattr(a[1][g], k), getattr(b[1][g], k))]
    bad += [g for g in a[1] if a[1][g].count != b[1][g].count]
    return bad


def test_mesh_step_matches_one_device_step(env):
    """One step over ["cpu"] * 2 against the port's one-device step from
    the same state with the same draws: the five losses (rtol 1e-6), the
    parameters (the first step's share rule), the running statistics
    (1e-5) and the Adam moments (the counts equal; the first moments, the
    gradients, within 1e-2 of their norm: measured 1.5e-6 for the
    template's and 2.3e-3 for the warp field's, whose gradients pass
    through PE(10) as the module docstring says)."""
    tb = _tbatch(env["batch"])
    t_rand = torch.from_numpy(_t_rand(400)[1].copy())
    one, mesh = _trainer(env), _trainer(env, _mesh(2))
    s1, m1 = one.train_step(one.init_state(env["port_model"]()), tb, LRS,
                            t_rand=t_rand)
    s2, m2 = mesh.train_step(mesh.init_state(env["port_model"]()), tb, LRS,
                             t_rand=t_rand)
    for k, v in m1.items():
        np.testing.assert_allclose(float(m2[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    a, b = s1.model.state_dict(), s2.model.state_dict()
    for gi, group in enumerate(("cano_template", "warping_field")):
        d = np.concatenate([np.abs(a[n].numpy() - b[n].numpy()).ravel()
                            for n in _param_names(s1.model, group)])
        assert d.max() <= 2 * LRS[gi] + 1e-6, (group, d.max())
        assert (d <= STEP_TOL[0]).mean() >= STEP_SHARE, group
    for k in a:
        if "running" in k:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    for g, opt in s1.opt.items():
        assert s2.opt[g].count == opt.count == 1
        rel = float((s2.opt[g].mu - opt.mu).norm() / opt.mu.norm())
        assert rel < 1e-2, (g, rel)
    assert not _state_equal((s2.model, s2.opt), s2.replicas[0])


def _jax_mesh_train_step(jtrainer, jstate, batch, lrs, key):
    from avatarcap_tpu.parallel.mesh import replicate, shard_batch
    mesh = _jax_mesh()
    with mesh:
        return jtrainer.train_step(
            replicate(mesh, jstate), shard_batch(mesh, _jbatch(batch)),
            replicate(mesh, jnp.asarray(lrs)), replicate(mesh, key))


@pytest.mark.parametrize("lrs", [(1e-3, 1e-4), (1e-3, 0.0)])
def test_mesh_steps_match_jax_sharded(env, lrs):
    """Two steps over ["cpu"] * 2 against JAX's train_step jitted over a
    2-device virtual mesh: the five losses, the statistics and the
    parameters (test_train_steps_match_jax's rules; its second step also
    starts both sides from JAX's state), the replicas bit-equal; at lrs
    (1e-3, 0) the warp field keeps its bits."""
    from avatarcap_tpu_torch.train.trainer import replicate_state
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    from test_torch_train import _adam_flat
    lrs = np.asarray(lrs, np.float32)
    jtrainer = env["jenv"]["trainer"]
    jstate = jtrainer.init_state(jax.tree.map(jnp.asarray,
                                              env["variables"]))
    mesh = _mesh(2)
    trainer = _trainer(env, mesh)
    model = env["port_model"]()
    state = trainer.init_state(model)
    tb = _tbatch(env["batch"])
    for step in range(2):
        key, t_rand = _t_rand(500 + step)
        jstate, jm = _jax_mesh_train_step(jtrainer, jstate, env["batch"],
                                          lrs, key)
        state, m = trainer.train_step(state, tb, lrs,
                                      t_rand=torch.from_numpy(t_rand))
        assert state.step == step + 1
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                       err_msg=k)
        _check_state(state, jstate, lrs, STEP_TOL[step])
        assert not _state_equal((state.model, state.opt), state.replicas[0])
        if lrs[1] == 0:
            for n, p in state.model.named_parameters():
                if n.startswith("warping_field."):
                    assert torch.equal(p, model.state_dict()[n]), n
        variables = {"params": _np(jstate.params),
                     "batch_stats": _np(jstate.batch_stats)}
        state.model.load_state_dict(avatar_state_dict_from_jax(variables))
        for g, opt in state.opt.items():
            mu, nu, count = _adam_flat(jstate.opt_state, g, variables,
                                       _param_names(state.model, g))
            opt.load_state_dict({"mu": mu, "nu": nu, "count": count})
        state = replicate_state(state._replace(replicas=()), mesh)


def test_mesh_finetune_matches_jax_sharded(env):
    """One finetune step over ["cpu"] * 2 against JAX's
    make_finetune_step over the 2-device virtual mesh: the losses, the
    template by the share rule, the warp field's bits, its statistics
    updated as JAX's (mesh-global), the anchors untouched, the replicas
    bit-equal."""
    import optax
    from avatarcap_tpu.parallel.mesh import replicate, shard_batch
    from avatarcap_tpu.train.finetune import make_finetune_step as jmake
    from avatarcap_tpu.train.trainer import TrainState
    from avatarcap_tpu_torch.train.finetune import (finetune_state,
                                                    make_finetune_step)
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    def label_fn(p):
        return jax.tree.map_with_path(
            lambda path, _: "train" if path[0].key == "cano_template"
            else "freeze", p)
    opt = optax.multi_transform(
        {"train": optax.adam(5e-4), "freeze": optax.set_to_zero()}, label_fn)
    jstep = jmake(env["module"], opt, env["js"], n_samples=N_SAMPLES)
    v = jax.tree.map(jnp.asarray, env["variables"])
    jstate = TrainState(jax.tree.map(jnp.copy, v["params"]),
                        jax.tree.map(jnp.copy, v["batch_stats"]),
                        opt.init(v["params"]), jnp.zeros((), jnp.int32))
    key, t_rand = _t_rand(600)
    jmesh = _jax_mesh()
    with jmesh:
        jstate, jm = jstep(replicate(jmesh, jstate), replicate(jmesh, v),
                           shard_batch(jmesh, _jbatch(env["batch"])),
                           replicate(jmesh, key))

    mesh = _mesh(2)
    anchors = [env["port_model"]() for _ in mesh]
    before = {k: t.clone() for k, t in anchors[0].state_dict().items()}
    state = finetune_state(env["port_model"](), mesh)
    step = make_finetune_step(env["tstatics"], n_samples=N_SAMPLES,
                              mesh=mesh)
    state, m = step(state, anchors, _tbatch(env["batch"]),
                    t_rand=torch.from_numpy(t_rand))
    for k, val in jm.items():
        np.testing.assert_allclose(float(m[k]), float(val), rtol=1e-5,
                                   err_msg=k)
    ref = avatar_state_dict_from_jax({"params": _np(jstate.params),
                                      "batch_stats": _np(
                                          jstate.batch_stats)})
    sd = state.model.state_dict()
    d = np.concatenate([np.abs(sd[n].numpy() - ref[n].numpy()).ravel()
                        for n in _param_names(state.model,
                                              "cano_template")])
    assert d.max() <= 2 * 5e-4 + 1e-6
    assert (d <= STEP_TOL[0]).mean() >= STEP_SHARE
    for n in _param_names(state.model, "warping_field"):
        assert torch.equal(sd[n], before[n]), n
    for k in ref:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            assert not torch.equal(sd[k], before[k]), k
    for anchor in anchors:
        for k, t in anchor.state_dict().items():
            assert torch.equal(t, before[k]), k
    assert set(state.opt) == {"cano_template"}
    assert not _state_equal((state.model, state.opt), state.replicas[0])
    with pytest.raises(ValueError, match="anchors"):
        step(state, anchors[:1], _tbatch(env["batch"]))


def test_mesh_of_one_and_indivisible_batches(env):
    """A one-device mesh is mesh=None bit for bit (two steps from one
    generator); a batch whose size does not divide by the mesh size, and a
    state without its replicas, raise ValueError."""
    from avatarcap_tpu_torch.parallel.mesh import make_mesh
    tb = _tbatch(env["batch"])
    runs = []
    for mesh in (None, make_mesh(["cpu"])):
        trainer = _trainer(env, mesh)
        state = trainer.init_state(env["port_model"]())
        gen = torch.Generator().manual_seed(7)
        for _ in range(2):
            state, m = trainer.train_step(state, tb, LRS, generator=gen)
        assert state.replicas == ()
        runs.append((state, m))
    (a, ma), (b, mb) = runs
    assert not _state_equal((a.model, a.opt), (b.model, b.opt))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)

    trainer = _trainer(env, _mesh(2))
    state = trainer.init_state(env["port_model"]())
    odd = {k: v[:1] for k, v in tb.items()}
    with pytest.raises(ValueError, match="does not split"):
        trainer.train_step(state, odd, LRS)
    with pytest.raises(ValueError, match="replicas"):
        trainer.train_step(state._replace(replicas=()), tb, LRS)
    with pytest.raises(ValueError, match="one device"):
        trainer.fit(None, 0, 1, 2, state)
