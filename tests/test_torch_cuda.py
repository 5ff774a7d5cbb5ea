"""lbm_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX (the machine with the card has none), so on the card it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances, max abs error: float64 1e-13 (a few ulp of O(1) values after
the steps run; the kernel contracts multiply-adds into FMAs, the plain
version does not); float32 2e-6.
"""

import ctypes

import numpy as np
import pytest
import torch

from lbm_tpu_torch.kernels import bgk, channel, collide_stream, les
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.scenes import channel as scene

OMEGA = 1.0 / 0.8
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
SHAPES = [(torch.float64, (21, 21)), (torch.float64, (101, 101)),
          (torch.float64, (64, 130)), (torch.float64, (4, 2)),
          (torch.float32, (256, 384))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _state(R, C, dtype, device, seed, incompressible=False, noisy=False):
    """An equilibrium at a seeded random flow; ``noisy`` multiplies each
    population by 1 + U(-0.03, 0.03), off equilibrium, where the KBC gamma
    is well defined (at equilibrium it is 0/0, regularised)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)), dtype=dtype,
                          device=device)
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    f = eq(u, rho)
    if noisy:
        f = f * torch.as_tensor(1.0 + rng.uniform(-0.03, 0.03, (9, R, C)),
                                dtype=dtype, device=device)
    return f.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_collide_stream_kernel_matches_plain(cuda, dtype, shape, substeps):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=1)
    plain = collide_stream.make_fused_step(R, C, bgk.bgk_collide_fn(OMEGA, dtype),
                                           dtype, substeps)
    before = collide_stream.COLLIDE_STREAM_BGK.launches
    got = bgk.make_fused_step(R, C, OMEGA, dtype, substeps)(f)
    torch.cuda.synchronize()
    assert collide_stream.COLLIDE_STREAM_BGK.launches - before == substeps
    assert got.is_cuda and got.dtype == dtype
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_channel_kernel_matches_plain(cuda, dtype, shape):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=2, incompressible=True)
    model = channel.channel_model(1.0 / 0.9, 1.02, 1.0)
    step = channel.make_channel_fused_step(R, C, 1.0 / 0.9, 1.02, 1.0, dtype)
    before = channel.CHANNEL_BGK.launches
    got, want = f, f
    for _ in range(10):
        got = step(got)
        want = model.step(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_BGK.launches - before == 10
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_horizontal_poiseuille_gate_on_the_card(cuda):
    """The reference's L2 <= 1e-11 gate in float64, every step through
    kernel 2 (test/horizontal_poiseuille_test.cpp:175)."""
    before = channel.CHANNEL_BGK.launches
    res = scene.horizontal_poiseuille(device=cuda, dtype=torch.float64)
    assert channel.CHANNEL_BGK.launches - before == res.steps
    assert res.l2 <= 1e-11, res.l2
    assert res.f.is_cuda


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        collide_stream.collide_stream_bgk(f[:, :, ::2], OMEGA)
    with pytest.raises(TypeError):
        channel.channel_bgk(f.half(), 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="R >= 4"):
        channel.channel_bgk(f[:, :3].contiguous(), 1.0, 1.0, 1.0)
    step = bgk.make_fused_step(8, 16, OMEGA, torch.float32)
    with pytest.raises(ValueError, match="step built for"):
        step(f)


KBC_S2 = 1.0 / 0.8  # bench.py's relaxation
LES = dict(tau0=0.5 + 3e-4, cs_smag=0.17)  # bench.py's LES constants


@pytest.mark.cuda
@pytest.mark.parametrize("gamma_impl", ["factored", "direct"])
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_kbc_kernel_matches_plain(cuda, dtype, shape, substeps, gamma_impl):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=3, noisy=True)
    plain = collide_stream.make_fused_step(
        R, C, collide_stream.kbc_collide_fn(KBC_S2, gamma_impl), dtype, substeps)
    before = collide_stream.COLLIDE_STREAM_KBC.launches
    got = collide_stream.make_kbc_fused_step(R, C, KBC_S2, dtype, substeps,
                                             gamma_impl)(f)
    torch.cuda.synchronize()
    assert collide_stream.COLLIDE_STREAM_KBC.launches - before == substeps
    assert got.is_cuda and got.dtype == dtype
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_channel_kbc_kernel_matches_plain(cuda, dtype, shape):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=4, noisy=True)
    args = (KBC_S2, 1.001, 1.0)
    plain = channel.kbc_channel_step(*args)
    step = channel.make_channel_fused_step(R, C, *args, dtype, family="kbc")
    before = channel.CHANNEL_KBC.launches
    got, want = f, f
    for _ in range(10):
        got = step(got)
        want = plain(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_KBC.launches - before == 10
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_les_kernel_matches_plain(cuda, dtype, shape, substeps):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=5, noisy=True)
    plain = collide_stream.make_fused_step(
        R, C, les.les_collide_fn(dtype=dtype, **LES), dtype, substeps)
    before = les.COLLIDE_STREAM_LES.launches
    got = les.make_les_fused_step(R, C, dtype=dtype, substeps=substeps, **LES)(f)
    torch.cuda.synchronize()
    assert les.COLLIDE_STREAM_LES.launches - before == substeps
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


WRAPPERS = {
    "collide_stream_kbc": lambda f: collide_stream.collide_stream_kbc(f, KBC_S2),
    "channel_kbc": lambda f: channel.channel_kbc(f, KBC_S2, 1.001, 1.0),
    "collide_stream_les": lambda f: les.collide_stream_les(f, **LES),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_new_kernels_reject_what_they_do_not_take(cuda, name):
    launch = WRAPPERS[name]
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(f.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(f[:, :, ::2])
    with pytest.raises(TypeError):
        launch(f.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(9, R, C\)"):
        launch(f[:8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs,kernel", [
    ("ulbm_poiseuille", dict(H=24, W=24, T=400, nu=1e-2),
     lambda: channel.CHANNEL_KBC),
    ("ulbm_double_shear", dict(H=32, W=32, T=50),
     lambda: collide_stream.COLLIDE_STREAM_KBC),
    ("les_double_shear", dict(H=32, W=32, T=48, u_max=0.1, substeps=4),
     lambda: les.COLLIDE_STREAM_LES),
])
def test_ulbm_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs, kernel):
    """Each ULBM scene in float64, every step through its kernel, against the
    same scene on the CPU (the plain versions): 1e-12 over the run."""
    from lbm_tpu_torch.scenes import ulbm

    before = kernel().launches
    got = getattr(ulbm, scene)(device=cuda, dtype=torch.float64, **kwargs)
    assert kernel().launches - before == kwargs["T"]  # one launch per step
    want = getattr(ulbm, scene)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-12


# --- the MRT-CG kernels 6-8 -------------------------------------------------------

def _two_phase_state(R, C, dtype, device, surface_tension, seed, droplet=False):
    """A full MRT-CG state (flat planes: red, blue, + fst in CSF mode) from
    the scenes' initial densities with every population scaled by a seeded
    1 + U(-0.03, 0.03) and a seeded surface-force carry."""
    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    model = MRTCGModel(red=red, blue=blue, sigma=1e-4)
    if droplet:
        r0 = mp.init_rho_droplet(R, C, red.rho_0, True, radius=R / 4)
        b0 = mp.init_rho_droplet(R, C, blue.rho_0, False, radius=R / 4)
    else:
        r0 = mp.init_rho_cosine(R, C, red.rho_0, True, -1.0)
        b0 = mp.init_rho_cosine(R, C, blue.rho_0, False, -1.0)
    st = model.init_state(r0, b0, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    planes = [st.red.f, st.blue.f]
    planes = [p * torch.as_tensor(rng.uniform(0.97, 1.03, p.shape), dtype=dtype,
                                  device=device) for p in planes]
    if surface_tension == "csf":
        planes.append(torch.as_tensor(rng.uniform(-1e-6, 1e-6, (2, R, C)), dtype=dtype,
                                      device=device))
    return torch.cat(planes).contiguous()


MRTCG_KW = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
MRTCG_SHAPES = [(torch.float64, (21, 13), False), (torch.float64, (100, 100), True),
                (torch.float32, (21, 13), False), (torch.float32, (100, 100), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("layout", ["reduced", "split", "full"])
@pytest.mark.parametrize("dtype,shape,droplet", MRTCG_SHAPES)
def test_mrtcg_kernels_match_plain(cuda, dtype, shape, droplet, layout, surface_tension):
    """Kernels 6 (reduced, 3 steps), 7 (split, 1 step) and 8 (full, 2 steps)
    against their plain versions on the same card: TOL, in both modes."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    R, C = shape
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    S = _two_phase_state(R, C, dtype, cuda, surface_tension, seed=R + C, droplet=droplet)
    csf = surface_tension == "csf"
    kernel, steps = {"reduced": (mrtcg.MRTCG_REDUCED, 3), "split": (mrtcg.MRTCG_SPLIT, 1),
                     "full": (mrtcg.MRTCG_FULL, 2)}[layout]
    if layout == "full":
        step = mrtcg.make_csf_fused_step if csf else mrtcg.make_mrtcg_fused_step
        step = step(R, C, red, blue, dtype=dtype, **MRTCG_KW)
        x = S if csf else S.reshape(2, 9, R, C)
    else:
        x = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C),
                                     surface_tension)
        factory = (mrtcg.make_mrtcg_reduced_step if layout == "reduced"
                   else mrtcg.make_mrtcg_split_step)
        step = factory(R, C, red, blue, dtype=dtype, surface_tension=surface_tension,
                       **MRTCG_KW)
    before = kernel.launches
    got = x
    for _ in range(steps):
        got = step(got)
    torch.cuda.synchronize()
    assert kernel.launches - before == steps
    plain = mrtcg.make_plain_step(red, blue, surface_tension=surface_tension,
                                  reduced_in=layout != "full",
                                  reduced_out=layout == "reduced", **MRTCG_KW)
    want = x.reshape(-1, R, C)
    for _ in range(steps):
        want = plain(want)
    assert got.is_cuda and got.dtype == dtype
    assert (got.reshape(-1, R, C) - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_mrtcg_substeps_launch_per_step(cuda):
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    R, C = 21, 13
    S = _two_phase_state(R, C, torch.float64, cuda, "perturbation", seed=7)
    G = mrtcg.reduce_mrtcg_state(S.reshape(2, 9, R, C))
    one = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                        dtype=torch.float64, **MRTCG_KW)
    four = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                         dtype=torch.float64, substeps=4, **MRTCG_KW)
    before = mrtcg.MRTCG_REDUCED.launches
    got = four(G)
    torch.cuda.synchronize()
    assert mrtcg.MRTCG_REDUCED.launches - before == 4
    assert torch.equal(got, one(one(one(one(G)))))


MRTCG_WRAPPERS = {
    "reduced": (10, lambda m: m.MRTCG_REDUCED),
    "split": (10, lambda m: m.MRTCG_SPLIT),
    "full": (18, lambda m: m.MRTCG_FULL),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MRTCG_WRAPPERS))
def test_mrtcg_kernels_reject_what_they_do_not_take(cuda, name):
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    planes, kernel = MRTCG_WRAPPERS[name]
    params = mrtcg.kernel_params(mp.DEFAULT_RED, mp.DEFAULT_BLUE, 1e-4, (0.0, 0.0), 0.1,
                                 True)
    out = 10 if name == "reduced" else 18

    def launch(S, p=planes):
        return mrtcg.launch_mrtcg(kernel(mrtcg), S, params, False, p, out)

    S = torch.zeros((planes, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(S.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(S[:, :, ::2])
    with pytest.raises(TypeError):
        launch(S.to(torch.int32))
    with pytest.raises(ValueError, match=rf"\({planes}, R, C\)"):
        launch(S[:planes - 1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs", [
    ("mrtcg_static_droplet", dict(R=25, C=25, T=20, radius=6.0)),
    ("mrtcg_rayleigh_taylor", dict(R=32, C=16, T=30)),
    ("mrt_csf_rayleigh_taylor", dict(R=32, C=16, T=20)),
])
def test_multiphase_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs):
    """Each MRT-CG scene in float64 through kernels 6 (T-1 launches) and 7
    (one launch), against the same scene on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    before = (mrtcg.MRTCG_REDUCED.launches, mrtcg.MRTCG_SPLIT.launches)
    got = getattr(mp, scene)(device=cuda, dtype=torch.float64, **kwargs)
    assert mrtcg.MRTCG_REDUCED.launches - before[0] == kwargs["T"] - 1
    assert mrtcg.MRTCG_SPLIT.launches - before[1] == 1
    want = getattr(mp, scene)(device="cpu", dtype=torch.float64, **kwargs)
    for g, w in ((got.state.red.f, want.state.red.f), (got.state.blue.f, want.state.blue.f),
                 (got.state.u, want.state.u)):
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12


# --- kernels 9-11: the channel variants, TRT and the power law --------------------

TAU_MAGIC = (3.0 / 16.0) ** 0.5 + 0.5
OM_MINUS = 1.0 / (0.5 + (3.0 / 16.0) / (1.2 - 0.5))  # TRT at tau 1.2, Lambda 3/16
VARIANTS = {
    "gravity": dict(omega=1 / TAU_MAGIC, incompressible=True, pressure=(1.0, 1.0, 0),
                    force=(-3e-4, 0.0), col_walls="bounce"),
    "specular": dict(omega=1 / TAU_MAGIC, incompressible=False,
                     pressure=(1.004, 1.0, 0), col_walls="specular"),
    "free_stream": dict(omega=1 / 0.55, incompressible=True, row_walls="abb",
                        abb_u=(0.1, 0.0), col_walls="specular"),
    "free_stream_cc": dict(omega=1 / 0.55, incompressible=False, row_walls="abb",
                           abb_u=(0.1, 0.0), col_walls="specular",
                           corner_consistent=True),
    "vertical": dict(omega=1 / TAU_MAGIC, incompressible=False,
                     pressure=(1.004, 1.0, 1), row_walls="bounce"),
    "vertical_incomp": dict(omega=1 / TAU_MAGIC, incompressible=True,
                            pressure=(1.004, 1.0, 1), row_walls="bounce"),
    "trt": dict(omega=1 / 1.2, incompressible=True, pressure=(1.004, 1.0, 0),
                col_walls="bounce", omega_minus=OM_MINUS),
}
VARIANT_SHAPES = [(torch.float64, (21, 21)), (torch.float64, (54, 42)),
                  (torch.float64, (4, 4)), (torch.float32, (256, 384))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", VARIANT_SHAPES)
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_channel_variant_kernel_matches_plain(cuda, name, dtype, shape):
    """Kernel 9 against its plain model step, 10 steps, from a noisy state;
    twice, so that a second writer of an entry shows as a difference."""
    kw = VARIANTS[name]
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=R + C, incompressible=kw["incompressible"],
               noisy=True)
    step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
    plain = channel.ChannelVariant(**kw).model().step
    before = channel.CHANNEL_VARIANT.launches
    runs = []
    for _ in range(2):
        got = f
        for _ in range(10):
            got = step(got)
        runs.append(got)
    want = f
    for _ in range(10):
        want = plain(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_VARIANT.launches - before == 20
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_trt_kernel_matches_plain(cuda, dtype, shape, substeps):
    from lbm_tpu_torch.kernels import trt

    R, C = shape
    f = _state(R, C, dtype, cuda, seed=6, noisy=True)
    kw = dict(omega_plus=1 / 0.9, omega_minus=OM_MINUS)
    plain = collide_stream.make_fused_step(R, C, trt.trt_collide_fn(dtype=dtype, **kw),
                                           dtype, substeps)
    before = trt.COLLIDE_STREAM_TRT.launches
    got = trt.make_trt_fused_step(R, C, dtype=dtype, substeps=substeps, **kw)(f)
    torch.cuda.synchronize()
    assert trt.COLLIDE_STREAM_TRT.launches - before == substeps
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("n,sigma_y", [(0.5, 0.0), (1.5, 0.0), (0.8, 5e-4), (1.0, 0.0)])
@pytest.mark.parametrize("dtype,shape", [(torch.float64, (64, 130)),
                                         (torch.float64, (21, 21)),
                                         (torch.float32, (256, 384))])
def test_power_law_kernel_matches_plain(cuda, dtype, shape, n, sigma_y):
    """Kernel 11 in its three branches (Picard for n = 0.5 and 1.5, Newton
    with a yield stress, the Newtonian constant), 3 steps from a noisy
    sheared state."""
    from lbm_tpu_torch.kernels import power_law
    from lbm_tpu_torch.scenes.ulbm import double_shear_init

    R, C = shape
    m0, u = double_shear_init(R, C, 0.08, device=cuda, dtype=dtype)
    rng = np.random.default_rng(7)
    f = (d2q9.equilibrium(u, m0) * torch.as_tensor(
        rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype, device=cuda)).contiguous()
    kw = dict(cons_K=0.01, n=n, sigma_y=sigma_y)
    plain = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8,
                                             dtype=dtype, **kw), dtype, 3)
    before = power_law.COLLIDE_STREAM_POWER_LAW.launches
    got = power_law.make_power_law_fused_step(R, C, dtype=dtype, substeps=3, **kw)(f)
    torch.cuda.synchronize()
    assert power_law.COLLIDE_STREAM_POWER_LAW.launches - before == 3
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


def _launch_variant(f):
    return channel.channel_variant(f, channel.ChannelVariant(**VARIANTS["gravity"]))


def _launch_trt(f):
    from lbm_tpu_torch.kernels import trt

    return trt.collide_stream_trt(f, 1 / 0.9, OM_MINUS)


def _launch_power_law(f):
    from lbm_tpu_torch.kernels import power_law

    return power_law.collide_stream_power_law(f, 0.01, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [_launch_variant, _launch_trt, _launch_power_law])
def test_kernels_9_to_11_reject_what_they_do_not_take(cuda, launch):
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(f.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(f[:, :, ::2])
    with pytest.raises(TypeError):
        launch(f.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(9, R, C\)"):
        launch(f[:8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs", [
    ("gravity_channel", dict(H=21, W=21, T=300, tolerance=0.0)),
    ("specular_channel", dict(H=31, W=21, T=300)),
    ("free_stream", dict(H=30, W=24, T=100)),
    ("free_stream", dict(H=30, W=24, T=200, corner_consistent=True)),
    ("vertical_poiseuille", dict(H=21, W=17, T=300)),
    ("vertical_poiseuille", dict(H=21, W=21, T=300, incompressible=True)),
    ("trt_poiseuille", dict(H=21, W=21, T=300)),
])
def test_channel_variant_scenes_on_the_card_match_the_cpu(cuda, name, kwargs):
    """Each kernel-9 scene in float64, one launch per step, against the same
    scene on the CPU (the plain model step): 1e-12."""
    before = channel.CHANNEL_VARIANT.launches
    got = getattr(scene, name)(device=cuda, dtype=torch.float64, **kwargs)
    assert channel.CHANNEL_VARIANT.launches - before == got.steps
    want = getattr(scene, name)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-12
    assert (got.u.cpu() - want.u).abs().max().item() <= 1e-12


@pytest.mark.cuda
def test_power_law_channel_on_the_card_matches_the_cpu(cuda):
    """The power-law channel has no kernel: plain tensor ops on the card,
    equal to the CPU run within 1e-10 (libdevice and the CPU's exp and log
    may differ by an ulp)."""
    kw = dict(H=4, W=41, T=400, dtype=torch.float64)
    got = scene.power_law_channel(device=cuda, **kw)
    want = scene.power_law_channel(device="cpu", **kw)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-10


# --- kernels 12-14: the RK mixture, the CSF droplet, Shan-Chen -----------------

RK_KW = dict(r_alpha=11 / 15, b_alpha=0.2, r_nu=0.04, b_nu=0.06, sigma=0.01, beta=0.7,
             gravity=(-6.25e-6, 0.0))
CSF_COLOURS = (dict(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=0.7),
               dict(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=-0.7))
NEW_SHAPES = [(torch.float64, (21, 13)), (torch.float64, (64, 130)), (torch.float64, (5, 4)),
              (torch.float32, (256, 384))]


def _rk_state(R, C, dtype, device):
    from lbm_tpu_torch.models import rk_cg
    from lbm_tpu_torch.scenes import multiphase as mp

    model = rk_cg.RKMixtureModel(r_rho_0=3.0, b_rho_0=1.0, **RK_KW)
    st = model.init_state(mp.init_rho_cosine(R, C, 3.0, False, 1.0),
                          mp.init_rho_cosine(R, C, 1.0, True, 1.0), dtype=dtype, device=device)
    return torch.cat([st.f, st.r_rho[None], st.b_rho[None]]).contiguous()


def _csf_state(R, C, dtype, device):
    from lbm_tpu_torch.models import mrt_csf_droplet as mcd
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = (mcd.CSFColour(**c) for c in CSF_COLOURS)
    radius = max(min(R, C) / 4, 1.0)
    st = mcd.CSFDropletModel(red, blue).init_state(
        mp.init_rho_droplet(R, C, 1.0, True, radius, 2.0),
        mp.init_rho_droplet(R, C, 1.0, False, radius, 2.0), dtype=dtype, device=device)
    return torch.cat([st.red.f, st.blue.f, torch.zeros((2, R, C), dtype=dtype,
                                                       device=device)]).contiguous(), red, blue


def _sc_state(R, C, dtype, device, cs):
    rng = np.random.default_rng(R + C)
    rho = (0.18 + 0.07 * rng.standard_normal((R, C)) if cs
           else 0.7 + 0.1 * rng.standard_normal((R, C)))
    return d2q9.equilibrium(torch.zeros((2, R, C), dtype=dtype, device=device),
                            torch.as_tensor(rho, dtype=dtype, device=device)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", NEW_SHAPES)
def test_rk_kernel_matches_plain(cuda, dtype, shape):
    """Kernel 12, 3 steps (one launch each) from the RT state, against its
    plain version: TOL (bit-identical on the H100 so far)."""
    from lbm_tpu_torch.kernels import rk

    R, C = shape
    S = _rk_state(R, C, dtype, cuda)
    before = rk.RK_CG.launches
    got = rk.make_rk_fused_step(R, C, dtype=dtype, substeps=3, **RK_KW)(S)
    torch.cuda.synchronize()
    assert rk.RK_CG.launches - before == 3
    want = S
    for _ in range(3):
        want = rk.make_plain_step(**RK_KW)(want)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", NEW_SHAPES)
def test_csf_droplet_kernel_matches_plain(cuda, dtype, shape):
    """Kernel 13, 3 steps from the droplet state, against its plain version."""
    from lbm_tpu_torch.kernels import csf_droplet as csd

    R, C = shape
    S, red, blue = _csf_state(R, C, dtype, cuda)
    before = csd.CSF_DROPLET.launches
    got = csd.make_csf_droplet_fused_step(R, C, red, blue, 0.1, dtype=dtype, substeps=3)(S)
    torch.cuda.synchronize()
    assert csd.CSF_DROPLET.launches - before == 3
    want = S
    for _ in range(3):
        want = csd.make_plain_step(red, blue, 0.1)(want)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("eos,forcing", [("sc", "guo"), ("sc", "shift"), ("cs", "shift"),
                                         ("cs", "guo")])
@pytest.mark.parametrize("dtype,shape", NEW_SHAPES)
def test_shan_chen_kernel_matches_plain(cuda, dtype, shape, eos, forcing):
    """Kernel 14 in each eos/forcing instance, 4 steps per call (4
    launches), against its plain version."""
    from lbm_tpu_torch.kernels import shan_chen as shc

    R, C = shape
    kw = dict(omega=1.0, T=0.7 * 0.09433) if eos == "cs" else dict(omega=1.0, G=-5.0)
    f = _sc_state(R, C, dtype, cuda, eos == "cs")
    before = shc.SHAN_CHEN.launches
    got = shc.make_sc_fused_step(R, C, eos=eos, forcing=forcing, dtype=dtype, substeps=4,
                                 **kw)(f)
    torch.cuda.synchronize()
    assert shc.SHAN_CHEN.launches - before == 4
    want = f
    for _ in range(4):
        want = shc.make_plain_step(eos=eos, forcing=forcing, **kw)(want)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_12_to_14_reject_what_they_do_not_take(cuda):
    from lbm_tpu_torch.kernels import _build, rk
    from lbm_tpu_torch.kernels import csf_droplet as csd
    from lbm_tpu_torch.kernels import shan_chen as shc

    _, red, blue = _csf_state(8, 16, torch.float64, cuda)
    csf_params = _build.c_doubles(csd.kernel_params(red, blue, 0.1))
    sc_params = _build.c_doubles(shc.kernel_params(1.0, -5.0)[2])
    rk_params = _build.c_doubles(rk.kernel_params(**RK_KW))
    launches = {
        11: lambda x: rk.launch_rk(x, rk_params),
        20: lambda x: collide_stream.launch_steps(csd.CSF_DROPLET, x, 1, csf_params, planes=20),
        9: lambda x: collide_stream.launch_steps(shc.SHAN_CHEN, x, 1, sc_params, 0, 0),
    }
    for planes, launch in launches.items():
        x = torch.zeros((planes, 8, 16), dtype=torch.float64, device=cuda)
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(x.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            launch(x[:, :, ::2])
        with pytest.raises(TypeError):
            launch(x.to(torch.int32))
        with pytest.raises(ValueError, match=rf"\({planes}, R, C\)"):
            launch(x[:planes - 1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs,kernel", [
    ("rk_rayleigh_taylor", dict(L=8, T=40), "rk"),
    ("csf_static_droplet", dict(L=24, T=20, radius=6.0), "csf"),
    ("rk_static_droplet", dict(L=21, T=20, radius=5.0), None),
])
def test_new_multiphase_scenes_on_the_card_match_the_cpu(cuda, name, kwargs, kernel):
    """Each new multiphase scene in float64 on the card (kernels 12 and 13,
    one launch per step; rk_static_droplet has no kernel) against the same
    scene on the CPU: 1e-12 (the CPU's sqrt is not correctly rounded, the
    card's is)."""
    from lbm_tpu_torch.kernels import csf_droplet as csd
    from lbm_tpu_torch.kernels import rk
    from lbm_tpu_torch.scenes import multiphase as mp

    counter = {"rk": rk.RK_CG, "csf": csd.CSF_DROPLET}.get(kernel)
    before = counter.launches if counter else 0
    got = getattr(mp, name)(device=cuda, dtype=torch.float64, **kwargs)
    if counter:
        assert counter.launches - before == kwargs["T"]
    want = getattr(mp, name)(device="cpu", dtype=torch.float64, **kwargs)
    for g, w in zip(got.state, want.state):
        g = g.f if hasattr(g, "f") else g
        w = w.f if hasattr(w, "f") else w
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs", [
    ("sc_phase_separation", dict(H=32, W=32, T=200, substeps=4)),
    ("sc_static_droplet", dict(H=32, W=32, T=100, radius=8.0)),
    ("sc_flat_interface", dict(H=32, W=8, T=200, substeps=2)),
    ("sc_cs_interface", dict(H=32, W=8, T=200, substeps=4)),
])
def test_shan_chen_scenes_on_the_card_match_the_cpu(cuda, name, kwargs):
    """Each Shan-Chen scene in float64 through kernel 14 (one launch per
    step) against the same scene on the CPU: 1e-12 (libdevice's exp and
    the CPU's may differ by an ulp)."""
    from lbm_tpu_torch.kernels import shan_chen as shc
    from lbm_tpu_torch.scenes import shan_chen as scs

    before = shc.SHAN_CHEN.launches
    got = getattr(scs, name)(device=cuda, dtype=torch.float64, **kwargs)
    assert shc.SHAN_CHEN.launches - before == kwargs["T"]
    want = getattr(scs, name)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.f.is_cuda and (got.f.cpu() - want.f).abs().max().item() <= 1e-12


# --- kernels 15-17: the IBM cylinder's grid step and forcing, sedimentation --------

OBSTACLE_SHAPES = [(torch.float64, (48, 40)), (torch.float64, (64, 130)),
                   (torch.float32, (256, 384))]


def _noisy_state(R, C, dtype, device, seed):
    return _state(R, C, dtype, device, seed, noisy=True)


@pytest.mark.cuda
@pytest.mark.parametrize("guo", [(1 / 3, 1 / 9), (3.0, 9.0)])
@pytest.mark.parametrize("dtype,shape", OBSTACLE_SHAPES)
def test_cylinder_kernel_matches_plain(cuda, dtype, shape, guo):
    """Kernel 15, 5 steps on a noisy state with a noisy 16x16 ROI force,
    against its plain version (bit-identical, -fmad=false), and again:
    two runs are bit-identical (one writer per entry)."""
    from lbm_tpu_torch.kernels import cylinder

    R, C = shape
    rng = np.random.default_rng(R + C)
    f = _noisy_state(R, C, dtype, cuda, seed=R * C)
    F = torch.as_tensor(rng.normal(0.0, 1e-3, (2, 16, 16)), dtype=dtype, device=cuda)
    origin = (R // 3, C // 2 - 8)
    step = cylinder.make_cylinder_fused_step(R, C, 1 / 0.55, (0.05, 0.0), guo, dtype)
    before = cylinder.CYLINDER.launches
    got, again, want = f, f, f
    for _ in range(5):
        got, again = step(got, F, origin), step(again, F, origin)
        want = cylinder.plain_cylinder_step(want, F, origin, 1 / 0.55, (0.05, 0.0), guo)
    torch.cuda.synchronize()
    assert cylinder.CYLINDER.launches - before == 10
    assert torch.equal(got, again)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("reference_weights", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("grid,circle", [
    ((64, 256), (30.0, 130.0, 9.0, 40)),     # lbm_tpu's kernel test
    ((160, 120), (60.0, 60.0, 20.0, 64)),    # cylinder_flow's defaults
    ((40, 40), (20.0, 20.0, 15.0, 48)),      # a ROI two cells from the edges
    ((160, 160), (80.0, 80.0, 60.0, 400)),   # 400 markers, a 125x125 ROI
    ((160, 160), (80.0, 80.0, 70.0, 1200)),  # past shared memory in float64: global scratch
])
def test_ibm_forcing_kernel_matches_plain(cuda, grid, circle, dtype, reference_weights):
    """Kernel 16 (one launch) against its plain version's matmuls: TOL (the
    sums run in another order), and two launches bit-identical."""
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.ops.ibm import IBM

    R, C = grid
    ib = IBM.circle(*circle, reference_transposed_weights=reference_weights)
    f = _noisy_state(R, C, dtype, cuda, seed=R + C)
    step = kibm.make_ibm_forcing_step(R, C, ib, dtype)
    before = kibm.IBM_FORCING.launches
    got, again = step(f), step(f)
    torch.cuda.synchronize()
    assert kibm.IBM_FORCING.launches - before == 2
    assert got.shape == (2,) + ib.roi_shape and torch.equal(got, again)
    want = ib.force_from_populations(f)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,geom", [
    (torch.float64, (64, 96), (-30, 50, 62, 16)),
    (torch.float64, (24, 20), (10, 5, 9, 0)),
    (torch.float32, (256, 320), (-151, 200, 250, 50)),
    (torch.float64, (256, 320), (-151, 200, 250, 50)),
    (torch.float32, (4096, 2048), (-151, 200, 250, 50)),
])
def test_sediment_kernel_matches_plain(cuda, dtype, shape, geom):
    """Kernel 17, 4 steps per call (4 launches) from the scene's initial
    state with noise, against its plain version, bit for bit, twice: at the
    scene's 256x320 in both types (one wave in float32: dependent launches),
    on small grids and at 4096x2048 (many waves: plain launches); a launch
    is dependent exactly where lbm_sediment_describe finds the grid in one
    wave."""
    from lbm_tpu_torch.kernels import _build, sediment
    from lbm_tpu_torch.scenes.obstacles import sediment_initial_state

    R, C = shape
    R23, C28, C38, inlet = geom
    kw = dict(omega=1 / 0.55, u_in=0.02, w_s=3e-3, C_w=1e-3, R23=R23, C28=C28, C38=C38,
              inlet_rows=inlet)
    rng = np.random.default_rng(R + C)
    S = sediment_initial_state(R, C, 0.02, 1e-3, inlet, cuda, dtype)
    S = (S * torch.as_tensor(rng.uniform(0.97, 1.03, S.shape), dtype=dtype,
                             device=cuda)).contiguous()
    step = sediment.make_sediment_fused_step(R, C, substeps=4, dtype=dtype, **kw)
    step(S)  # the occupancy read before the count starts
    lib = _build.library()
    lib.lbm_dependent_launches.restype = ctypes.c_longlong
    lib.lbm_sediment_describe.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    shape_of = (ctypes.c_longlong * 7)()
    assert lib.lbm_sediment_describe(R * C, int(dtype == torch.float64), shape_of) == 0
    before, pdl = sediment.SEDIMENT.launches, lib.lbm_dependent_launches()
    got, again = step(S), step(S)
    torch.cuda.synchronize()
    assert sediment.SEDIMENT.launches - before == 8
    assert lib.lbm_dependent_launches() - pdl == (8 if shape_of[5] else 0)
    if R * C <= 1 << 13 or R * C >= 1 << 22:  # under 100 blocks, or many waves
        assert shape_of[5] == (R * C <= 1 << 13)
    want = S
    for _ in range(4):
        want = sediment.plain_sediment_step(want, **dict(kw, R23=R23 % R))
    assert torch.equal(got, again)
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_sediment_kernel_past_31_bit_offsets(cuda):
    """Kernel 17 on a float32 state of 18 x R x 4096 entries, just past
    2^31 (8.6 GB a buffer): the 64-bit instance.  One step; its rows 1-5
    and last 6 rows bit for bit the plain step of the state's first and
    last 8 rows (R23 = R - 3, one inlet row).  A strip's own walls write
    only their own cells, and its rectangle top (the head strip's row 6)
    pushes only post-collision values.  Left out: row 0, whose scalar takes
    row R-1's push (the wrap), and the tail strip's row 1, which takes its
    row 0's pushes of the scalar that row 0 took from row 1."""
    from lbm_tpu_torch.kernels import sediment

    C, h = 4096, 8
    R = (2 ** 31 - 1) // (18 * C) + 1
    assert 18 * R * C > 2 ** 31 - 1
    kw = dict(omega=1 / 0.55, u_in=0.02, w_s=3e-3, C_w=1e-3, C28=200, C38=250, inlet_rows=1)
    gen = torch.Generator(device=cuda).manual_seed(R)
    S = torch.empty((18, R, C), dtype=torch.float32, device=cuda)
    w = [float(x) for x in (4 / 9, *[1 / 9] * 4, *[1 / 36] * 4)]
    for k in range(18):  # noisy populations, a plane at a time
        S[k].uniform_(0.97, 1.03, generator=gen).mul_(w[k % 9] * (1.0 if k < 9 else 1e-3))
    before = sediment.SEDIMENT.launches
    got = sediment.make_sediment_fused_step(R, C, R23=R - 3, **kw)(S)
    torch.cuda.synchronize()
    assert sediment.SEDIMENT.launches - before == 1
    head = sediment.plain_sediment_step(S[:, :h].contiguous(), R23=h - 2, **kw)[:, 1:h - 2]
    tail = sediment.plain_sediment_step(S[:, R - h:].contiguous(), R23=h - 3, **kw)[:, 2:]
    del S
    assert torch.equal(got[:, 1:h - 2], head) and torch.equal(got[:, R - h + 2:], tail)


@pytest.mark.cuda
def test_kernels_15_to_17_reject_what_they_do_not_take(cuda):
    from lbm_tpu_torch.kernels import cylinder, sediment
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.ops.ibm import IBM

    f = torch.zeros((9, 32, 32), dtype=torch.float64, device=cuda)
    F = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    consts = cylinder.cylinder_constants(1.0, (0.05, 0.0), (3.0, 9.0), torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cylinder.cylinder_step(f.cpu(), F, (0, 0), consts)
    with pytest.raises(ValueError, match="does not fit"):
        cylinder.cylinder_step(f, F, (28, 0), consts)
    with pytest.raises(ValueError, match="device and dtype"):
        cylinder.cylinder_step(f, F.float(), (0, 0), consts)
    with pytest.raises(ValueError, match="leaves"):
        kibm.make_ibm_forcing_step(32, 32, IBM.circle(4.0, 16.0, 3.0, 16), torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        kibm.make_ibm_forcing_step(32, 16, IBM.circle(16.0, 8.0, 3.0, 16),
                                   torch.float64)(f[:, :, ::2])
    S = torch.zeros((18, 32, 32), dtype=torch.float64, device=cuda)
    consts = sediment.sediment_constants(1.0, 0.02, 3e-3, 1e-3, torch.float64)
    geom = (ctypes.c_int * 4)(10, 10, 12, 4)
    with pytest.raises(ValueError, match=r"\(18, R, C\)"):
        collide_stream.launch_steps(sediment.SEDIMENT, S[:9].contiguous(), 1, consts, geom,
                                    planes=18)
    with pytest.raises(ValueError, match="does not fit"):
        sediment.make_sediment_fused_step(32, 32, omega=1.0, u_in=0.02, w_s=3e-3, C_w=1e-3,
                                          R23=10, C28=0, C38=12, inlet_rows=4)


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [
    dict(H=48, W=40, T=30, center=(20.3, 17.6), radius=6.0, n_markers=16,
         reference_weights=True),
    dict(H=48, W=40, T=30, center=(20.3, 17.6), radius=6.0, n_markers=16,
         guo_coeffs=(3.0, 9.0), record_every=10),
])
def test_cylinder_flow_on_the_card_matches_the_cpu(cuda, kwargs):
    """cylinder_flow in float64 through kernels 16 and 15 (one launch each
    per step) against the same scene on the CPU: 1e-12 (kernel 16 sums in
    another order than the plain matmuls)."""
    from lbm_tpu_torch.kernels import cylinder
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.scenes import obstacles

    before = cylinder.CYLINDER.launches, kibm.IBM_FORCING.launches
    got = obstacles.cylinder_flow(device=cuda, dtype=torch.float64, **kwargs)
    assert (cylinder.CYLINDER.launches - before[0],
            kibm.IBM_FORCING.launches - before[1]) == (kwargs["T"], kwargs["T"])
    want = obstacles.cylinder_flow(device="cpu", dtype=torch.float64, **kwargs)
    for name in ("f", "F_roi", "surface_force"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12
    if "record_every" in kwargs:
        assert got.forces.shape == (3, 2) and not got.forces.is_cuda
        assert (got.forces - want.forces).abs().max().item() <= 1e-12


@pytest.mark.cuda
def test_rectangle_sedimentation_on_the_card_matches_the_cpu(cuda):
    """rectangle_sedimentation in float64 through kernel 17 (one launch per
    step) against the same scene on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import sediment
    from lbm_tpu_torch.scenes import obstacles

    kw = dict(H=64, W=96, T=40, R23=-30, C28=50, C38=62, inlet_rows=16, substeps=4)
    before = sediment.SEDIMENT.launches
    got = obstacles.rectangle_sedimentation(device=cuda, dtype=torch.float64, **kw)
    assert sediment.SEDIMENT.launches - before == 40
    want = obstacles.rectangle_sedimentation(device="cpu", dtype=torch.float64, **kw)
    for name in ("f", "g", "C"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12


def _state_err(got, want):
    """Max error of a body state, relative to max(1, |value|): the lanes
    range from O(1e-4) velocities to O(100) centres and torques, and a
    float32 centre near 100 is 7.6e-6 from its neighbours."""
    return ((got.cpu() - want.cpu()).abs() / want.cpu().abs().clamp_min(1.0)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,window", [
    (torch.float64, (97, 61), (3, 40, 34, 21)),
    (torch.float64, (64, 128), (0, 0, 64, 128)),
    (torch.float32, (400, 256), (83, 111, 34, 34)),
])
def test_box_kernel_matches_plain(cuda, dtype, shape, window):
    """Kernel 18, 10 steps from a noisy state with a noisy force window read
    at a device origin, against plain_box_step, twice bit-identical."""
    from lbm_tpu_torch.kernels import cylinder

    R, C = shape
    r0, c0, rw, cw = window
    f = _noisy_state(R, C, dtype, cuda, seed=R + C)
    rng = np.random.default_rng(R * C)
    F = torch.as_tensor(rng.normal(0.0, 1e-3, (2, rw, cw)), dtype=dtype, device=cuda)
    origin = torch.tensor([r0, c0], dtype=torch.int32, device=cuda)
    step = cylinder.make_box_fused_step(R, C, 1 / 0.6, dtype=dtype)
    before = cylinder.BOX.launches
    got, again, want = f, f, f
    for _ in range(10):
        got = step(got, F, origin)
        again = step(again, F, origin)
        want = cylinder.plain_box_step(want, F, origin, 1 / 0.6)
    torch.cuda.synchronize()
    assert cylinder.BOX.launches - before == 20
    assert torch.equal(got, again)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


def _forcing_case(variant, dtype, device, edge):
    """(step, f, state) of one moving-forcing kernel at its scene's default
    window, or with the window clipped at a grid edge."""
    from lbm_tpu_torch.kernels import moving_ibm as km
    from lbm_tpu_torch.ops.moving_ibm import ellipse_markers

    th = np.linspace(0.0, 2.0 * np.pi, 76, endpoint=False)
    if variant == "forcing":
        H, W = 400, 256
        step = km.make_moving_forcing_step(H, W, 12 * np.cos(th), 12 * np.sin(th), half=17,
                                           g_net=5.655e-3, m_eff=565.5, dtype=dtype)
        state = km.pack_state((16.0, 240.5) if edge else (100.3, 128.0), (0.002, -0.001),
                              dtype=dtype, device=device)
    elif variant == "rot":
        H, W = 800, 256
        dx, dy = ellipse_markers(16.0, 8.0)
        step = km.make_moving_rot_step(H, W, dx, dy, half=21, g_net=2.01e-2, m_eff=502.7,
                                       i_eff=40212.0, dtype=dtype)
        state = km.pack_state_rot((19.5, 20.0) if edge else (200.2, 127.5),
                                  (np.cos(0.3), np.sin(0.3)), (0.003, 0.001), 1e-4,
                                  dtype=dtype, device=device)
    else:
        H, W = 800, 128
        step = km.make_moving_bodies_step(H, W, 12 * np.cos(th), 12 * np.sin(th), n_bodies=2,
                                          rw=228 if edge else 116, half=17, g_net=2.262e-2,
                                          m_eff=565.5, radius=12.0, dtype=dtype)
        centers = ((785.0, 63.0), (770.0, 110.0)) if edge else ((96.0, 63.0), (130.0, 64.0))
        state = km.pack_states(centers, ((0.003, 0.0), (0.004, 0.0005)), dtype=dtype,
                               device=device)
    return step, _noisy_state(H, W, dtype, device, seed=H + W), state


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("variant", ["forcing", "rot", "bodies"])
def test_moving_forcing_kernels_match_plain(cuda, variant, dtype, edge):
    """Kernels 19-21, 4 steps from a noisy state (the body state advancing),
    against their plain versions: F within TOL, the origin equal, two runs
    bit-identical, the state within TOL of max(1, |value|); a float32 state
    held to the float64 plain version on the same inputs: no farther from it
    than the float32 plain version, plus TOL (its force and torque are sums
    over 76-152 markers that two float32 orders round apart by ~1e-6)."""
    from lbm_tpu_torch.kernels import moving_ibm as km

    kernel = {"forcing": km.MOVING_FORCING, "rot": km.MOVING_ROT,
              "bodies": km.MOVING_BODIES}[variant]
    step, f, state = _forcing_case(variant, dtype, cuda, edge)
    before = kernel.launches
    got, again = state, state
    for _ in range(4):
        Fg, og, got = step(f, got)
        Fa, oa, again = step(f, again)
    torch.cuda.synchronize()
    assert kernel.launches - before == 8
    assert torch.equal(Fg, Fa) and torch.equal(og, oa) and torch.equal(got, again)
    want = state
    for _ in range(4):
        Fw, ow, want = step.plain(f, want)
    assert og.tolist() == ow.tolist()
    assert (Fg - Fw).abs().max().item() <= TOL[dtype]
    if dtype == torch.float64:
        assert _state_err(got, want) <= TOL[dtype]
        return
    step64 = _forcing_case(variant, torch.float64, cuda, edge)[0]
    truth = state.double()
    for _ in range(4):
        truth = step64.plain(f.double(), truth)[2]
    scale = truth.abs().clamp_min(1.0)
    excess = ((got.double() - truth).abs() - (want.double() - truth).abs()) / scale
    assert excess.max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_moving_bodies_kernel_at_overlapping_supports(cuda, dtype):
    """Kernel 21 with the two rings' centres 2 r + 1.4 apart (DKT's kissing
    gap is 1.407): their 4x4 supports share cells, where each body's
    interpolation must see the other's spread, as the plain version's union
    window couples them.  4 steps against plain_moving_bodies (F within TOL,
    the origin equal, the float32 state no farther from the float64 plain
    version than the float32 plain version, plus TOL), twice bit-identical."""
    from lbm_tpu_torch.kernels import moving_ibm as km

    th = np.linspace(0.0, 2.0 * np.pi, 76, endpoint=False)

    def case(dt):
        return km.make_moving_bodies_step(800, 128, 12 * np.cos(th), 12 * np.sin(th),
                                          n_bodies=2, rw=116, half=17, g_net=2.262e-2,
                                          m_eff=565.5, radius=12.0, dtype=dt)
    step = case(dtype)
    state = km.pack_states(((100.0, 63.0), (125.4, 63.3)), ((0.003, 0.0), (-0.003, 0.0005)),
                           dtype=dtype, device=cuda)
    f = _noisy_state(800, 128, dtype, cuda, seed=928)
    before = km.MOVING_BODIES.launches
    got, again, want = state, state, state
    for _ in range(4):
        Fg, og, got = step(f, got)
        Fa, oa, again = step(f, again)
        Fw, ow, want = step.plain(f, want)
    torch.cuda.synchronize()
    assert km.MOVING_BODIES.launches - before == 8
    assert torch.equal(Fg, Fa) and torch.equal(og, oa) and torch.equal(got, again)
    assert og.tolist() == ow.tolist() and (Fg - Fw).abs().max().item() <= TOL[dtype]
    # both rings force the cells between them
    rows = (Fg[0] != 0).any(dim=1).nonzero().flatten()
    assert rows.min().item() + og[0].item() < 100 < 125 < rows.max().item() + og[0].item()
    if dtype == torch.float64:
        assert _state_err(got, want) <= TOL[dtype]
        return
    truth = state.double()
    for _ in range(4):
        truth = case(torch.float64).plain(f.double(), truth)[2]
    scale = truth.abs().clamp_min(1.0)
    excess = ((got.double() - truth).abs() - (want.double() - truth).abs()) / scale
    assert excess.max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_18_to_21_reject_what_they_do_not_take(cuda):
    from lbm_tpu_torch.kernels import cylinder
    from lbm_tpu_torch.kernels import moving_ibm as km

    f = torch.ones((9, 32, 32), dtype=torch.float64, device=cuda)
    F = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    consts = cylinder.box_constants(1.5, (3.0, 9.0), torch.float64)
    origin = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cylinder.box_step(f.cpu(), F, origin, consts)
    with pytest.raises(ValueError, match="int32"):
        cylinder.box_step(f, F, origin.cpu(), consts)
    with pytest.raises(ValueError, match="device and dtype"):
        cylinder.box_step(f, F.float(), origin, consts)
    th = np.linspace(0.0, 2.0 * np.pi, 20, endpoint=False)
    step = km.make_moving_forcing_step(32, 32, 3 * np.cos(th), 3 * np.sin(th), half=8,
                                       g_net=0.0, m_eff=1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="state's device"):
        step(f, km.pack_state((16.0, 16.0), dtype=torch.float64))
    with pytest.raises(ValueError, match="body state"):
        step(f, km.pack_state((16.0, 16.0), dtype=torch.float32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs,kernel", [
    ("falling_cylinder", dict(H=64, W=96, T=20, center=(20.3, 47.0), radius=8.0,
                              rho_s=1.4, gravity=1e-4, record_every=5), "MOVING_FORCING"),
    ("falling_cylinders", dict(H=96, W=96, T=20, centers=((30.0, 40.0), (46.0, 60.0)),
                               radius=8.0, rho_s=1.4, gravity=1e-4, zeta=12.0,
                               record_every=5), "MOVING_BODIES"),
    ("falling_ellipse", dict(H=64, W=96, T=20, center=(24.0, 48.5), a=9.0, b=4.5,
                             theta0=0.5, rho_s=1.4, gravity=2e-4, record_every=5),
     "MOVING_ROT"),
])
def test_falling_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs, kernel):
    """The falling scenes in float64 through their forcing kernel and kernel
    18 (one launch each per step) against the same scene on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import cylinder
    from lbm_tpu_torch.kernels import moving_ibm as km
    from lbm_tpu_torch.scenes import obstacles

    k = getattr(km, kernel)
    before = cylinder.BOX.launches, k.launches
    got = getattr(obstacles, scene)(device=cuda, dtype=torch.float64, **kwargs)
    assert (cylinder.BOX.launches - before[0], k.launches - before[1]) == (20, 20)
    want = getattr(obstacles, scene)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.f.is_cuda and (got.f.cpu() - want.f).abs().max().item() <= 1e-12
    assert not got.trajectory.is_cuda and got.trajectory.shape[0] == 4
    assert (got.trajectory - want.trajectory).abs().max().item() <= 1e-12


def _thermal_state(q, R, C, dtype, device, seed):
    """[f, g] of the thermal steps off equilibrium: f a noisy seeded state,
    g the temperature's equilibrium populations (weights times theta in
    [-0.5, 0.5]), each times 1 + U(-0.03, 0.03)."""
    from lbm_tpu_torch.core import lattice as lat

    rng = np.random.default_rng(seed)
    w = lat.W if q == 9 else lat.W5
    theta = rng.uniform(-0.5, 0.5, (R, C))
    g = w[:, None, None] * theta * rng.uniform(0.97, 1.03, (q, R, C))
    return torch.cat([_noisy_state(R, C, dtype, device, seed),
                      torch.as_tensor(g, dtype=dtype, device=device)]).contiguous()


# rayleigh_benard's rates at its defaults (Ra 1e4, Pr 0.71, tau_g 0.8, H 64)
THERMAL = dict(omega_f=1.0 / (0.71 * 0.1 * 3.0 + 0.5), omega_g=1.25,
               g_beta=1e4 * 0.71 * 0.1 * 0.1 / 64 ** 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,L", [(torch.float64, 128), (torch.float64, 130),
                                     (torch.float64, 37), (torch.float32, 512)])
def test_cavity_kernel_matches_plain(cuda, dtype, L):
    """Kernel 22, 10 steps from a noisy state at the reference's
    super-critical force, against plain_cavity_step (bit-identical,
    -fmad=false), twice."""
    from lbm_tpu_torch.kernels import cavity

    f = _noisy_state(L, L, dtype, cuda, seed=L)
    omega = 1.0 / ((3.0 / 16.0) ** 0.5 + 0.5)
    step = cavity.make_cavity_fused_step(L, omega=omega, force=3e-3, substeps=5, dtype=dtype)
    before = cavity.CAVITY.launches
    got, again = step(step(f)), step(step(f))
    torch.cuda.synchronize()
    assert cavity.CAVITY.launches - before == 20
    want = f
    for _ in range(10):
        want = cavity.plain_cavity_step(want, omega=omega, force=3e-3)
    assert torch.equal(got, again)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
@pytest.mark.parametrize("kind", ["rb", "cavity"])
@pytest.mark.parametrize("dtype,shape", [(torch.float64, (64, 128)), (torch.float32, (64, 128)),
                                         (torch.float64, (128, 128)), (torch.float32, (128, 128)),
                                         (torch.float64, (33, 17)), (torch.float64, (4, 5))])
def test_thermal_kernels_match_plain(cuda, kind, lattice, dtype, shape):
    """Kernels 23 (rb) and 24 (cavity) in both scalar lattices, 10 steps
    from a noisy buoyant state, against their plain versions (bit-identical,
    -fmad=false), twice; at the launch shapes of the thermal gates (64x128
    and 128x128) in both types, programmatic dependent launches."""
    from lbm_tpu_torch.kernels import thermal

    R, C = shape
    q = thermal.scalar_planes(lattice)
    S = _thermal_state(q, R, C, dtype, cuda, seed=R * C + q)
    make, plain, kernel = {
        "rb": (thermal.make_thermal_fused_step, thermal.plain_rb_step, thermal.THERMAL[q]),
        "cavity": (thermal.make_heated_cavity_fused_step, thermal.plain_heated_cavity_step,
                   thermal.HEATED_CAVITY[q])}[kind]
    step = make(R, C, substeps=5, dtype=dtype, scalar_lattice=lattice, **THERMAL)
    before = kernel.launches
    got, again = step(step(S)), step(step(S))
    torch.cuda.synchronize()
    assert kernel.launches - before == 20
    want = S
    for _ in range(10):
        want = plain(want, **THERMAL)
    assert torch.equal(got, again) and got.shape == (9 + q, R, C)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
@pytest.mark.parametrize("kind", ["rb", "cavity"])
def test_thermal_kernels_past_31_bit_offsets(cuda, kind, lattice):
    """Kernels 23 and 24 on a float32 state of (9 + q) x R x 4096 entries,
    just past 2^31 (8.6 GB a buffer): the 64-bit instance.  One step; its
    first and last 7 rows against the plain step of the state's first and
    last 8 rows (each strip's rows hold their walls, its columns the
    grid's: a row's step reads only its neighbours, and the strip's own
    wall on its inner row writes that row alone)."""
    from lbm_tpu_torch.core import lattice as lat
    from lbm_tpu_torch.kernels import thermal

    q = thermal.scalar_planes(lattice)
    C, h = 4096, 8
    R = (2 ** 31 - 1) // ((9 + q) * C) + 1
    assert (9 + q) * R * C > 2 ** 31 - 1
    make, plain, kernel = {
        "rb": (thermal.make_thermal_fused_step, thermal.plain_rb_step, thermal.THERMAL[q]),
        "cavity": (thermal.make_heated_cavity_fused_step, thermal.plain_heated_cavity_step,
                   thermal.HEATED_CAVITY[q])}[kind]
    gen = torch.Generator(device=cuda).manual_seed(R + q)
    S = torch.empty((9 + q, R, C), dtype=torch.float32, device=cuda)
    w = list(lat.W) + list(lat.W if q == 9 else lat.W5)
    theta = torch.rand((R, C), generator=gen, device=cuda) - 0.5
    for k in range(9 + q):  # noisy populations, a plane at a time
        S[k].uniform_(0.97, 1.03, generator=gen).mul_(float(w[k]))
        if k >= 9:
            S[k].mul_(theta)
    before = kernel.launches
    got = make(R, C, dtype=torch.float32, scalar_lattice=lattice, **THERMAL)(S)
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    head = plain(S[:, :h].contiguous(), **THERMAL)[:, :h - 1]
    tail = plain(S[:, R - h:].contiguous(), **THERMAL)[:, 1:]
    del S
    for part, want in ((got[:, :h - 1], head), (got[:, R - h + 1:], tail)):
        assert part.isfinite().all() and (part - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
def test_kernels_22_to_24_reject_what_they_do_not_take(cuda):
    from lbm_tpu_torch.kernels import cavity, thermal

    f = torch.ones((9, 16, 16), dtype=torch.float64, device=cuda)
    consts = cavity.cavity_constants(1.5, 3e-5, torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        collide_stream.launch_steps(cavity.CAVITY, f.cpu(), 1, consts)
    with pytest.raises(RuntimeError, match="cudaError_t"):  # not square
        collide_stream.launch_steps(cavity.CAVITY, f[:, :8].contiguous(), 1, consts)
    S = torch.ones((18, 16, 16), dtype=torch.float64, device=cuda)
    consts = thermal.thermal_constants(1.0, 1.25, 1e-4, torch.float64)
    with pytest.raises(ValueError, match=r"\(14, R, C\)"):
        collide_stream.launch_steps(thermal.THERMAL[5], S, 1, consts, planes=14)
    with pytest.raises(ValueError, match="contiguous"):
        collide_stream.launch_steps(thermal.HEATED_CAVITY[9], S[:, :, ::2], 1, consts,
                                    planes=18)
    step = thermal.make_thermal_fused_step(16, 16, dtype=torch.float64, **THERMAL)
    with pytest.raises(ValueError, match="step built for"):
        step(S.float())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs", [
    ("ring_cavity", dict(L=64, T=40)),
    ("rayleigh_benard", dict(H=32, W=64, T=40, amp=1e-2, record_every=10)),
    ("rayleigh_benard", dict(H=32, W=64, T=40, amp=1e-2, record_every=10,
                             scalar_lattice="d2q5")),
    ("heated_cavity", dict(H=32, W=48, T=40, snapshot_every=20)),
    ("heated_cavity", dict(H=32, W=48, T=40, substeps=4, scalar_lattice="d2q5")),
])
def test_cavity_and_thermal_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs):
    """The three scenes in float64 through kernels 22-24 (one launch per
    step) against the same scenes on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import cavity, thermal
    from lbm_tpu_torch.scenes import cavity as cavity_scene
    from lbm_tpu_torch.scenes import thermal as thermal_scene

    q = 5 if kwargs.get("scalar_lattice") == "d2q5" else 9
    fn, k = {"ring_cavity": (cavity_scene.ring_cavity, cavity.CAVITY),
             "rayleigh_benard": (thermal_scene.rayleigh_benard, thermal.THERMAL[q]),
             "heated_cavity": (thermal_scene.heated_cavity, thermal.HEATED_CAVITY[q])}[scene]
    before = k.launches
    got = fn(device=cuda, dtype=torch.float64, **kwargs)
    assert k.launches - before == kwargs["T"]
    want = fn(device="cpu", dtype=torch.float64, **kwargs)
    names = ("f", "u") if scene == "ring_cavity" else ("f", "g", "theta", "u")
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12
    if scene != "ring_cavity":
        assert abs(got.nusselt - want.nusselt) <= 1e-12
    if kwargs.get("record_every"):
        assert not got.series.is_cuda and (got.series - want.series).abs().max().item() <= 1e-12
    if kwargs.get("snapshot_every"):
        for name, v in want.snapshots.items():
            assert np.abs(got.snapshots[name] - v).max() <= 1e-12


# kernels 25 and 26: the four wall sets of the D3Q19 step
D3Q19_WALLS = {
    "periodic": dict(),
    "channel": dict(x_walls=True, force_z=1e-5),
    "cavity": dict(x_walls=True, y_walls=True, z_walls=True, lid_u=0.05),
    "cavity_no_x": dict(y_walls=True, z_walls=True, lid_u=0.05),
}


def _d3q19_state(X, Y, Z, dtype, device, seed):
    """An equilibrium at a seeded flow (|u| <= 0.05, rho within 1%), every
    population times 1 + U(-0.03, 0.03)."""
    from lbm_tpu_torch.ops import d3q19

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (3, X, Y, Z)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (X, Y, Z)), dtype=dtype,
                          device=device)
    noise = torch.as_tensor(rng.uniform(0.97, 1.03, (19, X, Y, Z)), dtype=dtype,
                            device=device)
    return (d3q19.equilibrium(u, rho) * noise).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("walls", sorted(D3Q19_WALLS))
@pytest.mark.parametrize("dtype,shape", [(torch.float64, (5, 37, 41)),
                                         (torch.float64, (3, 4, 130)),
                                         (torch.float32, (8, 64, 128))])
def test_d3q19_kernels_match_plain(cuda, walls, dtype, shape):
    """Kernel 25, 10 steps (5 per call) from a noisy state, against
    plain_d3q19_step (bit-identical, -fmad=false), twice; kernel 26 on the
    lanes layout, unpacked, equal to kernel 25."""
    from lbm_tpu_torch.kernels import d3q19

    X, Y, Z = shape
    kw = dict(omega=1.0 / 0.7, **D3Q19_WALLS[walls])
    f = _d3q19_state(X, Y, Z, dtype, cuda, seed=X * Y + Z)
    step = d3q19.make_d3q19_fused_step(X, Y, Z, substeps=5, dtype=dtype, **kw)
    lanes = d3q19.make_d3q19_lanes_step(X, Y, Z, substeps=5, dtype=dtype, **kw)
    before, before26 = d3q19.D3Q19.launches, d3q19.D3Q19_LANES.launches
    got, again = step(step(f)), step(step(f))
    got26 = d3q19.unpack_lanes(lanes(lanes(d3q19.pack_lanes(f))), X, Y, Z)
    torch.cuda.synchronize()
    assert d3q19.D3Q19.launches - before == 20
    assert d3q19.D3Q19_LANES.launches - before26 == 10
    want = f
    for _ in range(10):
        want = d3q19.plain_d3q19_step(want, **kw)
    assert torch.equal(got, again) and torch.equal(got26, got)
    assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_25_26_reject_what_they_do_not_take(cuda):
    from lbm_tpu_torch.kernels import d3q19

    f = torch.ones((19, 2, 3, 4), dtype=torch.float64, device=cuda)
    consts = d3q19.d3q19_constants(1.2, 0.0, 0.0, torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        d3q19.launch_d3q19(d3q19.D3Q19, f.cpu(), 2, 3, 4, 1, consts, 0)
    with pytest.raises(ValueError, match="contiguous"):
        d3q19.launch_d3q19(d3q19.D3Q19, f[:, :, :, ::2], 2, 3, 2, 1, consts, 0)
    with pytest.raises(ValueError, match="19 x 2 x 3 x 5"):
        d3q19.launch_d3q19(d3q19.D3Q19, f, 2, 3, 5, 1, consts, 0)
    with pytest.raises(TypeError, match="float32 or float64"):
        d3q19.launch_d3q19(d3q19.D3Q19, f.half(), 2, 3, 4, 1, consts, 0)
    step = d3q19.make_d3q19_fused_step(2, 3, 4, omega=1.2, dtype=torch.float64)
    with pytest.raises(ValueError, match="step built for"):
        step(f.float())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs", [
    ("poiseuille_3d", dict(X=12, Y=4, Z=6, T=40, force=1e-5)),
    ("taylor_green_3d", dict(N=12, T=40, substeps=4)),
    ("lid_cavity_3d", dict(X=4, Y=16, Z=20, T=40, x_walls=True)),
    ("lid_cavity_3d", dict(X=3, Y=16, Z=20, T=40, x_walls=False, substeps=2)),
])
def test_3d_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs):
    """The three 3-D scenes in float64 through kernel 25 (one launch per
    step) against the same scenes on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import d3q19
    from lbm_tpu_torch.scenes import three_d

    fn = getattr(three_d, scene)
    before = d3q19.D3Q19.launches
    got = fn(device=cuda, dtype=torch.float64, **kwargs)
    assert d3q19.D3Q19.launches - before == kwargs["T"]
    want = fn(device="cpu", dtype=torch.float64, **kwargs)
    for name in ("f", "rho", "u"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12
    if want.l2 is not None:
        assert abs(got.l2 - want.l2) <= 1e-12


@pytest.mark.cuda
def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """lid_cavity_3d on the card interrupted at step 30 and resumed to 50
    from its checkpoint: bit-identical to the uninterrupted run."""
    from lbm_tpu_torch.scenes import three_d

    kw = dict(X=4, Y=16, Z=20, substeps=2, device=cuda, dtype=torch.float64)
    ref = three_d.lid_cavity_3d(T=50, **kw)
    d = str(tmp_path / "ck")
    three_d.lid_cavity_3d(T=30, checkpoint_dir=d, checkpoint_every=10, **kw)
    res = three_d.lid_cavity_3d(T=50, checkpoint_dir=d, checkpoint_every=10, **kw)
    assert res.f.is_cuda and torch.equal(res.f, ref.f)


# --- the row-sharded kernels 27-30 --------------------------------------------------

def _sharded_case(family, R, C, dtype, device, n, s):
    """(sharded step on n shards of ``device``, single-device step of s steps
    per call, state, the kernels the sharded step launches) of one case."""
    from lbm_tpu_torch.kernels import mrtcg, power_law, rk, thermal, trt
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import multiphase as mp

    mesh = pm.make_mesh([device] * n)
    seed = R * C + n * 10 + s
    if family in ("bgk", "kbc", "les", "trt", "power_law"):
        fn, single = {
            "bgk": (bgk.bgk_collide_fn(OMEGA, dtype),
                    bgk.make_fused_step(R, C, OMEGA, dtype, s)),
            "kbc": (collide_stream.kbc_collide_fn(OMEGA),
                    collide_stream.make_kbc_fused_step(R, C, OMEGA, dtype, s)),
            "les": (les.les_collide_fn(dtype=dtype, **LES),
                    les.make_les_fused_step(R, C, dtype=dtype, substeps=s, **LES)),
            "trt": (trt.trt_collide_fn(1.0 / 0.9, OM_MINUS, dtype),
                    trt.make_trt_fused_step(R, C, omega_plus=1.0 / 0.9, omega_minus=OM_MINUS,
                                            dtype=dtype, substeps=s)),
            "power_law": (power_law.power_law_collide_fn(0.01, 0.5, 0.52, 50.0, 8, dtype),
                          power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=0.5,
                                                              dtype=dtype, substeps=s)),
        }[family]
        return (ksh.make_sharded_fused_step(mesh, R, C, fn, dtype, substeps=s), single,
                _state(R, C, dtype, device, seed, noisy=True),
                [ksh.HALO_COLLIDE_STREAM[family]])
    if family == "thermal":
        return (ksh.make_sharded_thermal_step(mesh, R, C, substeps=s, dtype=dtype, **THERMAL),
                thermal.make_thermal_fused_step(R, C, substeps=s, dtype=dtype, **THERMAL),
                _thermal_state(9, R, C, dtype, device, seed), [ksh.HALO_THERMAL])
    if family in ("mrtcg", "csf"):
        mode = "csf" if family == "csf" else "perturbation"
        red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
        S = _two_phase_state(R, C, dtype, device, mode, seed)
        G = mrtcg.reduce_mrtcg_state(S if mode == "csf" else S.reshape(2, 9, R, C), mode)
        return (ksh.make_sharded_mrtcg_reduced_step(mesh, R, C, red, blue, dtype=dtype,
                                                    surface_tension=mode, substeps=s,
                                                    **MRTCG_KW),
                mrtcg.make_mrtcg_reduced_step(R, C, red, blue, dtype=dtype,
                                              surface_tension=mode, substeps=s, **MRTCG_KW),
                G, [ksh.HALO_MRTCG])
    return (ksh.make_sharded_rk_step(mesh, R, C, dtype=dtype, **RK_KW),
            rk.make_rk_fused_step(R, C, dtype=dtype, **RK_KW), _rk_state(R, C, dtype, device),
            [ksh.HALO_RK])


@pytest.mark.cuda
@pytest.mark.parametrize("family,n,s", [
    ("bgk", 1, 1), ("bgk", 2, 3), ("bgk", 8, 8), ("kbc", 8, 1), ("les", 4, 8),
    ("trt", 8, 2), ("power_law", 8, 8), ("thermal", 1, 1), ("thermal", 8, 8),
    ("thermal", 4, 3), ("mrtcg", 8, 1), ("mrtcg", 4, 2), ("mrtcg", 2, 5), ("csf", 8, 1),
    ("csf", 2, 4), ("rk", 8, 1), ("rk", 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_kernels_match_single_device(cuda, family, n, s, dtype):
    """Kernels 27-30 on n shards of one card, two calls of s steps: bit for
    bit the single-device kernel of their family, within TOL of the plain
    sharded version, and bit-identical run twice.  Kernels 28 and 29 launch
    once a shard and sweep, kernels 27 and 30 once a call over up to
    MAX_SHARDS shards of the card."""
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = (192, 40) if family in ("mrtcg", "csf", "rk") else (64, 72)
    step, single, x, kernels = _sharded_case(family, R, C, dtype, cuda, n, s)
    mesh = pm.make_mesh([cuda] * n)
    before = [k.launches for k in kernels]
    got = step(step(pm.shard_state(mesh, x))).gather()
    again = step(step(pm.shard_state(mesh, x))).gather()
    plain = step.plain(step.plain(pm.shard_state(mesh, x))).gather()
    torch.cuda.synchronize()
    per_call = -(-n // 8) if family in ("bgk", "kbc", "les", "trt", "power_law", "rk") \
        else n * s
    assert sum(k.launches for k in kernels) - sum(before) == 4 * per_call
    want = single(single(x))
    assert got.is_cuda and torch.equal(got, want) and torch.equal(got, again)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_sharded_kernels_reject_what_they_do_not_take(cuda):
    """A CUDA shard reaches kernels 27-30 or raises: a collide function
    without a kernel tag, a halo of the wrong depth, a CPU halo."""
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 64, 16
    mesh = pm.make_mesh([cuda] * 4)
    f = _state(R, C, torch.float64, cuda, seed=7)
    untagged = bgk.bgk_collide_fn(OMEGA, torch.float64)
    untagged = (lambda fn: (lambda g: fn(g)))(untagged)
    with pytest.raises(ValueError, match="names no halo-input kernel"):
        ksh.make_sharded_fused_step(mesh, R, C, untagged, torch.float64)(pm.shard_state(mesh, f))
    local = ksh.make_local_halo_step(16, C, bgk.bgk_collide_fn(OMEGA, torch.float64),
                                     torch.float64)
    shard = f[:, :16].contiguous()
    top = shard[:, :8].contiguous()
    with pytest.raises(ValueError, match="halo bot"):
        local(shard, top, shard[:, :4].contiguous())
    with pytest.raises(ValueError, match="halo bot"):
        local(shard, top, top.cpu())
    with pytest.raises(ValueError, match="halo top"):
        local(shard, top.float(), top)


# --- kernels 31-34: the full MRT-CG, Shan-Chen and D3Q19 row shards, and the
# rows x cols collide-stream ------------------------------------------------------

SC_CASES = {"sc guo": dict(omega=1.0, G=-5.0, eos="sc", forcing="guo"),
            "sc shift": dict(omega=1.0, G=-5.0, eos="sc", forcing="shift"),
            "cs shift": dict(omega=1.0, eos="cs", T=0.7 * 0.09433, forcing="shift"),
            "cs guo": dict(omega=1.0, eos="cs", T=0.7 * 0.09433, forcing="guo")}


def _k31_33_case(family, R, C, dtype, device, n, s):
    """(sharded step on n shards of ``device``, single-device step of s steps
    per call, state as the sharded step takes it, its kernels) of one case:
    "mrtcg" / "csf" (kernel 31 against kernel 8), an entry of SC_CASES
    (kernel 32 against 14), "d3q19 <walls>" (kernel 33 against 25 at X = 3
    and Z = C, the y axis R rows)."""
    from lbm_tpu_torch.kernels import d3q19, mrtcg, shan_chen
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import multiphase as mp

    mesh = pm.make_mesh([device] * n)
    seed = R * C + n * 10 + s
    if family in ("mrtcg", "csf"):
        mode = "csf" if family == "csf" else "perturbation"
        red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
        S = _two_phase_state(R, C, dtype, device, mode, seed)
        step = ksh.make_sharded_mrtcg_step(mesh, R, C, red, blue, dtype=dtype,
                                           surface_tension=mode, substeps=s, **MRTCG_KW)
        if mode == "csf":
            single = mrtcg.make_csf_fused_step(R, C, red, blue, dtype=dtype, substeps=s,
                                               **MRTCG_KW)
        else:
            full = mrtcg.make_mrtcg_fused_step(R, C, red, blue, dtype=dtype, substeps=s,
                                               **MRTCG_KW)
            single = lambda x: full(x.reshape(2, 9, R, C)).reshape(18, R, C)  # noqa: E731
        return step, single, S, [ksh.HALO_MRTCG_FULL]
    if family in SC_CASES:
        kw = SC_CASES[family]
        return (ksh.make_sharded_sc_step(mesh, R, C, substeps=s, dtype=dtype, **kw),
                shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **kw),
                _sc_state(R, C, dtype, device, kw["eos"] == "cs"), [ksh.HALO_SHAN_CHEN])
    X, kw = 3, dict(omega=1.0 / 0.7, **D3Q19_WALLS[family.split()[1]])
    one = d3q19.make_d3q19_fused_step(X, R, C, substeps=s, dtype=dtype, **kw)
    return (ksh.make_sharded_d3q19_step(mesh, X, R, C, substeps=s, dtype=dtype, **kw),
            lambda x: one(x.reshape(19, X, R, C)).reshape(19 * X, R, C),
            _d3q19_state(X, R, C, dtype, device, seed).reshape(19 * X, R, C),
            [ksh.HALO_D3Q19])


@pytest.mark.cuda
@pytest.mark.parametrize("family,n,s", [
    ("mrtcg", 1, 1), ("mrtcg", 8, 2), ("mrtcg", 4, 5), ("csf", 8, 1), ("csf", 4, 4),
    ("sc guo", 8, 4), ("sc shift", 1, 1), ("cs shift", 2, 2), ("cs guo", 8, 3),
    ("d3q19 periodic", 8, 8), ("d3q19 cavity", 1, 1), ("d3q19 cavity", 8, 2),
    ("d3q19 channel", 4, 5)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_kernels_31_to_33_match_single_device(cuda, family, n, s, dtype):
    """Kernels 31-33 on n shards of one card, two calls of s steps: bit for
    bit the single-device kernel of their family (8, 14, 25), within TOL of
    the plain sharded version, and bit-identical run twice.  Kernel 31
    launches once a shard and sweep, kernels 32 and 33 once a sweep over up
    to MAX_SHARDS shards of the card."""
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = (192, 40) if family in ("mrtcg", "csf") else (64, 72)
    step, single, x, kernels = _k31_33_case(family, R, C, dtype, cuda, n, s)
    mesh = pm.make_mesh([cuda] * n)
    before = [k.launches for k in kernels]
    got = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    again = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    plain = step.plain(step.plain(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    torch.cuda.synchronize()
    per_sweep = n if family in ("mrtcg", "csf") else -(-n // 8)
    assert sum(k.launches for k in kernels) - sum(before) == 4 * per_sweep * s
    want = single(single(x))
    assert got.is_cuda and torch.equal(got, want) and torch.equal(got, again)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((1, 1), 1), ((2, 4), 8), ((4, 2), 3), ((8, 1), 2)])
@pytest.mark.parametrize("kind", ["bgk", "kbc", "les", "trt", "power_law"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_34_matches_single_device(cuda, kind, shape, s, dtype):
    """Kernel 34 on an (nx, ny) mesh of one card's shards, two calls of s
    steps: bit for bit the single-device kernel of the collision (1, 3, 5,
    10, 11), within TOL of the plain sharded version, twice the same; one
    launch a call over up to MAX_SHARDS shards."""
    from lbm_tpu_torch.kernels import power_law, sharded2d, trt
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 64, 96
    fn, single = {
        "bgk": (bgk.bgk_collide_fn(OMEGA, dtype), bgk.make_fused_step(R, C, OMEGA, dtype, s)),
        "kbc": (collide_stream.kbc_collide_fn(OMEGA),
                collide_stream.make_kbc_fused_step(R, C, OMEGA, dtype, s)),
        "les": (les.les_collide_fn(dtype=dtype, **LES),
                les.make_les_fused_step(R, C, dtype=dtype, substeps=s, **LES)),
        "trt": (trt.trt_collide_fn(1.0 / 0.9, OM_MINUS, dtype),
                trt.make_trt_fused_step(R, C, omega_plus=1.0 / 0.9, omega_minus=OM_MINUS,
                                        dtype=dtype, substeps=s)),
        "power_law": (power_law.power_law_collide_fn(0.01, 0.5, 0.52, 50.0, 8, dtype),
                      power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=0.5,
                                                          dtype=dtype, substeps=s)),
    }[kind]
    mesh = pm.make_mesh([cuda] * (shape[0] * shape[1]), shape)
    step = sharded2d.make_sharded_fused_step_2d(mesh, R, C, fn, dtype, substeps=s)
    x = _state(R, C, dtype, cuda, seed=R + C + s, noisy=True)
    kernel = sharded2d.HALO2D_COLLIDE_STREAM[kind]
    before = kernel.launches
    got = step(step(pm.shard_state(mesh, x))).gather()
    again = step(step(pm.shard_state(mesh, x))).gather()
    plain = step.plain(step.plain(pm.shard_state(mesh, x))).gather()
    torch.cuda.synchronize()
    assert kernel.launches - before == 4 * -(-shape[0] * shape[1] // 8)
    assert got.is_cuda and torch.equal(got, single(single(x))) and torch.equal(got, again)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_31_to_34_reject_what_they_do_not_take(cuda):
    """A CUDA shard reaches kernels 31-34 or raises: an untagged collide
    function, a strip of the wrong width, a CPU strip."""
    from lbm_tpu_torch.kernels import sharded2d
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 32, 32
    mesh = pm.make_mesh([cuda] * 4, (2, 2))
    f = _state(R, C, torch.float64, cuda, seed=7)
    untagged = (lambda fn: (lambda g: fn(g)))(bgk.bgk_collide_fn(OMEGA, torch.float64))
    with pytest.raises(ValueError, match="names no halo-input kernel"):
        sharded2d.make_sharded_fused_step_2d(mesh, R, C, untagged, torch.float64)(
            pm.shard_state(mesh, f))
    local = sharded2d.make_local_2d_step(R, C, bgk.bgk_collide_fn(OMEGA, torch.float64),
                                         torch.float64)
    top, bot, left, right = halo.exchange_2d([[f]], 8)[0]
    with pytest.raises(ValueError, match="halo left"):
        local(f, top, bot, left[..., :4].contiguous(), right)
    with pytest.raises(ValueError, match="halo right"):
        local(f, top, bot, left, right.cpu())
    assert torch.equal(local(f, top, bot, left, right),
                       bgk.make_fused_step(R, C, OMEGA, torch.float64)(f))


def _k27_34_collision(kind, R, C, dtype, s):
    """(collide function, single-device step of s steps) of one of kernels 27
    and 34's collisions (kernels 1, 3, 5, 10, 11)."""
    from lbm_tpu_torch.kernels import power_law, trt

    return {
        "bgk": lambda: (bgk.bgk_collide_fn(OMEGA, dtype),
                        bgk.make_fused_step(R, C, OMEGA, dtype, s)),
        "kbc": lambda: (collide_stream.kbc_collide_fn(OMEGA),
                        collide_stream.make_kbc_fused_step(R, C, OMEGA, dtype, s)),
        "les": lambda: (les.les_collide_fn(dtype=dtype, **LES),
                        les.make_les_fused_step(R, C, dtype=dtype, substeps=s, **LES)),
        "trt": lambda: (trt.trt_collide_fn(1.0 / 0.9, OM_MINUS, dtype),
                        trt.make_trt_fused_step(R, C, omega_plus=1.0 / 0.9, omega_minus=OM_MINUS,
                                                dtype=dtype, substeps=s)),
        "power_law": lambda: (power_law.power_law_collide_fn(0.01, 0.5, 0.52, 50.0, 8, dtype),
                              power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=0.5,
                                                                  dtype=dtype, substeps=s)),
    }[kind]()


def _tile(s, dtype, kind):
    """The cells a tile of the sharded call's tile engine writes at s steps
    (csrc/collide_stream.cuh ``Box``: 48 x 64, less s lines a side; 96 x 64
    for the long collisions in float32)."""
    tall = dtype == torch.float32 and kind in ("kbc", "power_law")
    return (96 if tall else 48) - 2 * s, 64 - 2 * s


@pytest.mark.cuda
@pytest.mark.parametrize("s", range(1, 9))
@pytest.mark.parametrize("kind", ["bgk", "kbc", "les", "trt", "power_law"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", [27, 34])
def test_kernels_27_34_every_collision_and_cadence(cuda, kernel, dtype, kind, s):
    """Kernels 27 (3 row shards) and 34 (a (2, 2) mesh) at s = 1..8 steps a
    call, every collision, both types, on shards at a tile's edge: a shard of
    exactly one tile's rows (27) or one more (34), and one column past a tile
    or one short, odd: one launch a call, bit for bit the single-device
    kernel run s times, within TOL of the plain sharded version."""
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    tr, tc = _tile(s, dtype, kind)
    if kernel == 27:
        shape, R, C = None, 3 * tr, 2 * tc + 1
        mesh = pm.make_mesh([cuda] * 3)
    else:
        shape, R, C = (2, 2), 2 * (tr + 1), 2 * (tc - 1)
        mesh = pm.make_mesh([cuda] * 4, shape)
    fn, single = _k27_34_collision(kind, R, C, dtype, s)
    make = ksh.make_sharded_fused_step if kernel == 27 else k2d.make_sharded_fused_step_2d
    step = make(mesh, R, C, fn, dtype, substeps=s)
    counted = (ksh.HALO_COLLIDE_STREAM if kernel == 27 else k2d.HALO2D_COLLIDE_STREAM)[kind]
    x = _state(R, C, dtype, cuda, seed=R + C + s, noisy=True)
    before = counted.launches
    got = step(pm.shard_state(mesh, x)).gather()
    torch.cuda.synchronize()
    assert counted.launches - before == 1
    assert got.is_cuda and torch.equal(got, single(x))
    plain = step.plain(pm.shard_state(mesh, x)).gather()
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_27_34_copy_nothing_on_one_card_and_refuse_a_batch(cuda, monkeypatch):
    """On shards of one card kernels 27 and 34 read their neighbours' lines
    in place: the step makes no exchange copy (``step.plain`` makes its
    exchange's); a launch the kernel refuses (more than MAX_SHARDS shards, or
    more steps than the parts' halo) raises, no fallback."""
    import ctypes

    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies = []
    copy_to = halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or copy_to(src, dev))
    fn = bgk.bgk_collide_fn(OMEGA, torch.float64)
    x = _state(128, 96, torch.float64, cuda, seed=3, noisy=True)
    for make, shape in ((ksh.make_sharded_fused_step, (8, 1)),
                        (k2d.make_sharded_fused_step_2d, (4, 2))):
        mesh = pm.make_mesh([cuda] * 8, shape)
        step = make(mesh, 128, 96, fn, torch.float64, substeps=8)
        got = step(pm.shard_state(mesh, x)).gather()
        assert copies == []
        assert torch.equal(got, bgk.make_fused_step(128, 96, OMEGA, torch.float64, 8)(x))
        step.plain(pm.shard_state(mesh, x))
        assert copies
        copies.clear()
    kernel = ksh.HALO_COLLIDE_STREAM["bgk"]
    f = x[:, :16].contiguous()
    out = torch.empty_like(f)
    geom = ksh.block_geom(f, ksh.row_parts(f, f[:, -8:], f[:, :8]), out, True)
    params = _build.c_doubles([OMEGA])
    for n, s in ((9, 8), (1, 9)):
        geoms = (ctypes.c_longlong * (len(geom) * n))(*geom * n)
        with pytest.raises(RuntimeError, match="launch failed"):
            kernel.launch(geoms, params, n, s, 0, 0, 1, _build.stream_handle(f))


# --- kernels 35-38: the rows x cols body steps ---------------------------------------

def _k35_38_case(family, R, C, dtype, device, shape, s):
    """(rows x cols step on an ``shape`` mesh of ``device``'s shards, the
    single-device step of s steps per call, the flat state, its kernel) of
    one case: an entry of SC_CASES (kernel 35 against 14), "thermal" (36
    against 23, D2Q9), "rk" (37 against 12), "mrtcg" / "csf" (38 against 8;
    "... droplet": from the droplet, which varies along the columns)."""
    from lbm_tpu_torch.kernels import mrtcg, rk, shan_chen, thermal
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import multiphase as mp

    mesh = pm.make_mesh([device] * (shape[0] * shape[1]), shape)
    seed = R * C + 10 * shape[0] + shape[1] + s
    if family in SC_CASES:
        kw = SC_CASES[family]
        return (k2d.make_sharded2d_sc_step(mesh, R, C, substeps=s, dtype=dtype, **kw),
                shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **kw),
                _sc_state(R, C, dtype, device, kw["eos"] == "cs"), k2d.HALO2D_SHAN_CHEN)
    if family == "thermal":
        return (k2d.make_sharded2d_thermal_step(mesh, R, C, substeps=s, dtype=dtype,
                                                **THERMAL),
                thermal.make_thermal_fused_step(R, C, substeps=s, dtype=dtype, **THERMAL),
                _thermal_state(9, R, C, dtype, device, seed), k2d.HALO2D_THERMAL)
    if family == "rk":
        return (k2d.make_sharded2d_rk_step(mesh, R, C, dtype=dtype, **RK_KW),
                rk.make_rk_fused_step(R, C, dtype=dtype, **RK_KW),
                _rk_state(R, C, dtype, device), k2d.HALO2D_RK)
    mode = "csf" if family.startswith("csf") else "perturbation"
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    S = _two_phase_state(R, C, dtype, device, mode, seed, droplet=family.endswith("droplet"))
    step = k2d.make_sharded2d_mrtcg_step(mesh, R, C, red, blue, dtype=dtype,
                                         surface_tension=mode, substeps=s, **MRTCG_KW)
    if mode == "csf":
        single = mrtcg.make_csf_fused_step(R, C, red, blue, dtype=dtype, substeps=s, **MRTCG_KW)
    else:
        full = mrtcg.make_mrtcg_fused_step(R, C, red, blue, dtype=dtype, substeps=s,
                                           **MRTCG_KW)
        single = lambda x: full(x.reshape(2, 9, R, C)).reshape(18, R, C)  # noqa: E731
    return step, single, S, k2d.HALO2D_MRTCG_FULL


@pytest.mark.cuda
@pytest.mark.parametrize("family,shape,s", [
    ("sc guo", (1, 2), 4), ("sc guo", (4, 2), 1), ("cs shift", (2, 4), 2),
    ("thermal", (1, 2), 1), ("thermal", (4, 2), 8), ("thermal", (2, 4), 3),
    ("rk", (1, 2), 1), ("rk", (4, 2), 1), ("rk", (2, 4), 1),
    ("mrtcg", (1, 2), 2), ("mrtcg", (4, 2), 1), ("mrtcg droplet", (2, 4), 2),
    ("csf", (1, 2), 1), ("csf", (4, 2), 1), ("csf droplet", (2, 4), 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_35_to_38_match_single_device(cuda, family, shape, s, dtype):
    """Kernels 35-38 on an (nx, ny) mesh of one card's shards, two calls of s
    steps: bit for bit the single-device kernel of their family (14, 23,
    12, 8), within TOL of the plain rows x cols version, and bit-identical
    run twice.  A call launches s sweeps on each shard, kernels 35-37 s
    sweeps over all the shards of the card (up to MAX_SHARDS a launch)."""
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 64, 96
    step, single, x, kernel = _k35_38_case(family, R, C, dtype, cuda, shape, s)
    mesh = pm.make_mesh([cuda] * (shape[0] * shape[1]), shape)
    before = kernel.launches
    got = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    again = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    plain = step.plain(step.plain(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    torch.cuda.synchronize()
    n = shape[0] * shape[1]
    per_call = (-(-n // k2d.MAX_SHARDS) * s if family in ("thermal", "rk") or family in SC_CASES
                else n * s)
    assert kernel.launches - before == 4 * per_call
    want = single(single(x))
    assert got.is_cuda and torch.equal(got, want) and torch.equal(got, again)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernels_35_to_38_reject_what_they_do_not_take(cuda):
    """A CUDA shard reaches kernels 35-38 or raises: a state of another type
    than the step's, a strip of the wrong width, a CPU strip (kernel 35
    takes the strips as ``strip_parts``' 3 x 3 parts of the padded block)."""
    from lbm_tpu_torch.kernels import _build, shan_chen
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 32, 32
    mesh = pm.make_mesh([cuda] * 4, (2, 2))
    S = _thermal_state(9, R, C, torch.float64, cuda, seed=3)
    step = k2d.make_sharded2d_thermal_step(mesh, R, C, dtype=torch.float64, **THERMAL)
    with pytest.raises(ValueError, match="step built for"):
        step(pm.shard_state(mesh, S.float()))
    f = _sc_state(R, C, torch.float64, cuda, False)
    top, bot, left, right = halo.exchange_2d([[f]], 8)[0]
    params = _build.c_doubles(shan_chen.kernel_params(1.0, -5.0, "sc", None, None)[2])

    def launch(*strips):
        return k2d.launch_parts_shards(
            k2d.HALO2D_SHAN_CHEN, [(f, halo.strip_parts(f, *strips), 0, 0, False)], substeps=1,
            params=params, ints=(0, 0), rows_per_sweep=2, plain=None)[0]

    with pytest.raises(ValueError, match="halo top left"):
        launch(top, bot, left[..., :4].contiguous(), right)
    with pytest.raises(ValueError, match="halo top right"):
        launch(top, bot, left, right.cpu())
    assert torch.equal(launch(top, bot, left, right),
                       shan_chen.make_sc_fused_step(R, C, omega=1.0, G=-5.0,
                                                    dtype=torch.float64)(f))
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 4\]"):
        k2d.make_sharded2d_sc_step(mesh, R, C, omega=1.0, G=-5.0, substeps=5)


def _sc_sharded(kind, n, R, C, instance, dtype, devices, s):
    """(kernel 32's or 35's step on ``devices``, its mesh, its kernel): row
    shards for "rows", an (nx, ny) mesh ``n`` for "rows x cols"."""
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    if kind == "rows":
        mesh = pm.make_mesh(devices)
        return (ksh.make_sharded_sc_step(mesh, R, C, substeps=s, dtype=dtype,
                                         **SC_CASES[instance]), mesh, ksh.HALO_SHAN_CHEN)
    mesh = pm.make_mesh(devices, n)
    return (k2d.make_sharded2d_sc_step(mesh, R, C, substeps=s, dtype=dtype, **SC_CASES[instance]),
            mesh, k2d.HALO2D_SHAN_CHEN)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,R,C", [("rows", 8, 128, 72), ("rows", 16, 128, 40),
                                        ("rows x cols", (4, 2), 64, 96),
                                        ("rows x cols", (4, 4), 64, 128)])
@pytest.mark.parametrize("instance", sorted(SC_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_32_35_one_launch_a_sweep_and_no_copy(cuda, monkeypatch, dtype, instance, kind,
                                                     n, R, C):
    """Kernels 32 (row shards) and 35 (rows x cols) on shards of one card, in
    every eos x forcing instance and both types: a call of 3 sweeps is 3
    launches over up to MAX_SHARDS shards (16 shards: 6), makes no exchange
    copy (``step.plain`` makes its exchange's), gives kernel 14's bits, and
    a CUDA graph of two calls gives the eager run's bits."""
    from lbm_tpu_torch.kernels import _build, shan_chen
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies, copy_to = [], halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or copy_to(src, dev))
    shards = n[0] * n[1] if kind == "rows x cols" else n
    s = 3
    step, mesh, kernel = _sc_sharded(kind, n, R, C, instance, dtype, [cuda] * shards, s)
    x = _sc_state(R, C, dtype, cuda, instance.startswith("cs"))
    before = kernel.launches
    eager = step(step(pm.shard_state(mesh, x))).gather()
    torch.cuda.synchronize()
    assert kernel.launches - before == 2 * s * -(-shards // _build.MAX_SHARDS)
    assert copies == []
    single = shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **SC_CASES[instance])
    assert torch.equal(eager, single(single(x)))
    step.plain(pm.shard_state(mesh, x))
    assert copies
    xs = pm.shard_state(mesh, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(xs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = step(step(xs))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(ys.gather(), eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("rows", 4), ("rows x cols", (2, 2))])
def test_kernels_32_35_with_a_shard_on_a_second_card(cuda, monkeypatch, kind, n):
    """Kernels 32 and 35 with three shards on card 0 and one on card 1: each
    card's shards in their own launches, copies only between the cards,
    kernel 14's bits on card 0, in float64."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    from lbm_tpu_torch.kernels import shan_chen
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies, copy_to = [], halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(
        (src.device, torch.device(dev))) or copy_to(src, dev))
    R, C, s, f64 = 64, 96, 4, torch.float64
    devices = [torch.device("cuda", 0)] * 3 + [torch.device("cuda", 1)]
    step, mesh, kernel = _sc_sharded(kind, n, R, C, "sc guo", f64, devices, s)
    x = _sc_state(R, C, f64, devices[0], False)
    before = kernel.launches
    got = step(pm.shard_state(mesh, x)).gather(devices[0])
    torch.cuda.synchronize()
    assert kernel.launches - before == 2 * s
    assert copies and all(a != b for a, b in copies)
    single = shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=f64, **SC_CASES["sc guo"])
    assert torch.equal(got, single(x))


# --- kernels 37 and 14 redesigned: one launch a call over a card's shards; ---------
# --- one-period wraps and a dependent launch ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape,R,C", [((4, 2), 64, 96), ((2, 2), 40, 70),
                                             ((4, 4), 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_37_one_launch_a_call_and_no_copy(cuda, monkeypatch, dtype, mesh_shape, R, C):
    """Kernel 37 on shards of one card, edge and interior row ranks in one
    launch on (4, 2) and (4, 4), edge ranks only on (2, 2): a call is one
    launch over up to MAX_SHARDS shards (16 shards: 2), makes no exchange
    copy (``step.plain`` makes its exchange's), gives kernel 12's bits over 3
    calls, within TOL of the plain rows x cols version, and a CUDA graph of
    two calls gives the eager run's bits."""
    from lbm_tpu_torch.kernels import _build, rk
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies, copy_to = [], halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or copy_to(src, dev))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = pm.make_mesh([cuda] * n, mesh_shape)
    step = k2d.make_sharded2d_rk_step(mesh, R, C, dtype=dtype, **RK_KW)
    x = _rk_state(R, C, dtype, cuda)
    before = k2d.HALO2D_RK.launches
    eager = step(step(step(pm.shard_state(mesh, x)))).gather()
    torch.cuda.synchronize()
    assert k2d.HALO2D_RK.launches - before == 3 * -(-n // _build.MAX_SHARDS)
    assert copies == []
    single = rk.make_rk_fused_step(R, C, dtype=dtype, substeps=3, **RK_KW)
    assert torch.equal(eager, single(x))
    plain = step.plain(step.plain(step.plain(pm.shard_state(mesh, x)))).gather()
    assert copies and (eager - plain).abs().max().item() <= TOL[dtype]
    xs = pm.shard_state(mesh, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(xs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = step(step(xs))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(ys.gather(), step(step(xs)).gather())


# --- kernel 30 redesigned: one launch a call over a card's row shards, -------------
# --- the neighbours' edge rows read in place ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,R,C", [(8, 1024, 256), (4, 64, 40), (16, 192, 40)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_30_one_launch_a_call_and_no_copy(cuda, monkeypatch, dtype, n, R, C):
    """Kernel 30 on n row shards of one card (rk_rayleigh_taylor's 1024x256
    on 8; 16 shards: two launches), edge and interior ranks in one launch: a
    call is one launch over up to MAX_SHARDS shards, makes no exchange copy
    (``step.plain`` makes its exchange's), gives kernel 12's bits over 3
    calls (0.0), within TOL of the plain sharded version, and a CUDA graph
    of two calls gives the eager run's bits."""
    from lbm_tpu_torch.kernels import _build, rk
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies, copy_to = [], halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or copy_to(src, dev))
    mesh = pm.make_mesh([cuda] * n)
    step = ksh.make_sharded_rk_step(mesh, R, C, dtype=dtype, **RK_KW)
    x = _rk_state(R, C, dtype, cuda)
    before = ksh.HALO_RK.launches
    eager = step(step(step(pm.shard_state(mesh, x)))).gather()
    torch.cuda.synchronize()
    assert ksh.HALO_RK.launches - before == 3 * -(-n // _build.MAX_SHARDS)
    assert copies == []
    single = rk.make_rk_fused_step(R, C, dtype=dtype, substeps=3, **RK_KW)
    assert torch.equal(eager, single(x))
    plain = step.plain(step.plain(step.plain(pm.shard_state(mesh, x)))).gather()
    assert copies and (eager - plain).abs().max().item() <= TOL[dtype]
    xs = pm.shard_state(mesh, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(xs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = step(step(xs))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(ys.gather(), step(step(xs)).gather())


@pytest.mark.cuda
def test_kernel_30_with_a_shard_on_a_second_card(cuda, monkeypatch):
    """Kernel 30 with three row shards on card 0 and one on card 1: each
    card's shards in their own launch, copies only between the cards,
    kernel 12's bits on card 0, in float64."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    from lbm_tpu_torch.kernels import rk
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel import mesh as pm

    copies, copy_to = [], halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(
        (src.device, torch.device(dev))) or copy_to(src, dev))
    R, C, f64 = 64, 40, torch.float64
    devices = [torch.device("cuda", 0)] * 3 + [torch.device("cuda", 1)]
    mesh = pm.make_mesh(devices)
    step = ksh.make_sharded_rk_step(mesh, R, C, dtype=f64, **RK_KW)
    x = _rk_state(R, C, f64, devices[0])
    before = ksh.HALO_RK.launches
    got = step(pm.shard_state(mesh, x)).gather(devices[0])
    torch.cuda.synchronize()
    assert ksh.HALO_RK.launches - before == 2
    assert copies and all(a != b for a, b in copies)
    assert torch.equal(got, rk.make_rk_fused_step(R, C, dtype=f64, **RK_KW)(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128), (4096, 2048), (40, 20), (5, 7)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_14_matches_plain_at_its_shapes(cuda, dtype, shape):
    """Kernel 14 (sc/guo, and cs/shift at the small grids), 4 steps a call
    (4 launches, dependent in one wave), at sc_flat_interface's 256x128, at
    4096x2048 (many waves) and on grids narrower (40x20) and shorter and
    narrower (5x7) than a tile: within TOL of its plain version."""
    from lbm_tpu_torch.kernels import shan_chen as shc

    R, C = shape
    cases = [("sc", "guo")] + ([("cs", "shift")] if R * C < 1 << 20 else [])
    for eos, forcing in cases:
        kw = dict(omega=1.0, T=0.7 * 0.09433) if eos == "cs" else dict(omega=1.0, G=-5.0)
        f = _sc_state(R, C, dtype, cuda, eos == "cs")
        before = shc.SHAN_CHEN.launches
        got = shc.make_sc_fused_step(R, C, eos=eos, forcing=forcing, dtype=dtype, substeps=4,
                                     **kw)(f)
        torch.cuda.synchronize()
        assert shc.SHAN_CHEN.launches - before == 4
        plain = shc.make_plain_step(eos=eos, forcing=forcing, **kw)
        want = plain(plain(plain(plain(f))))
        assert got.is_cuda and (got - want).abs().max().item() <= TOL[dtype]
        del got, want, f


# --- kernel 39: the lane-blocked reduced MRT-CG step ------------------------------

# (R, C, lane_block, substeps): LB in {128, 256, C} at s in {1, 2, 5}, and
# the ADVICE.md shapes (R = 24, C = 256, LB + 256 > C), where lbm_tpu's lanes
# step fails to trace
LANES_CASES = ([(37, 512, lb, s) for lb in (128, 256, 512) for s in (1, 2, 5)]
               + [(24, 256, 256, 2), (24, 256, 128, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,lane_block,substeps", LANES_CASES)
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lanes_kernel_matches_kernel_6_and_plain(cuda, dtype, surface_tension, R, C,
                                                 lane_block, substeps):
    """Kernel 39, one launch per step, bit for bit kernel 6 run ``substeps``
    times, and within TOL of its plain version on the same card."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    csf = surface_tension == "csf"
    S = _two_phase_state(R, C, dtype, cuda, surface_tension, seed=R + lane_block + substeps)
    G = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C), surface_tension)
    kw = dict(dtype=dtype, surface_tension=surface_tension, substeps=substeps, **MRTCG_KW)
    lanes = mrtcg.make_mrtcg_reduced_lanes_step(R, C, red, blue, lane_block=lane_block, **kw)
    before = mrtcg.MRTCG_REDUCED_LANES.launches
    got = lanes(G)
    torch.cuda.synchronize()
    assert mrtcg.MRTCG_REDUCED_LANES.launches - before == substeps
    want = mrtcg.make_mrtcg_reduced_step(R, C, red, blue, **kw)(G)
    plain = mrtcg.plain_mrtcg_reduced_lanes_step(
        G, mrtcg.make_plain_step(red, blue, surface_tension=surface_tension, **MRTCG_KW),
        lane_block, substeps, mrtcg.rows_per_sweep(surface_tension))
    assert got.is_cuda and got.dtype == dtype and got.shape == G.shape
    assert torch.equal(got, want)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("surface_tension,substeps", [("perturbation", 42), ("csf", 25)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lanes_kernel_deepest_calls_match_kernel_6(cuda, dtype, surface_tension, substeps):
    """The deepest call whose window fits in 2C (LB = C = 256: margins of
    126, CSF 125, wrapping past C), one launch per step, bit for bit
    kernel 6, from the layers at rest; one step more is refused."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    R, C = 48, 256
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    st = MRTCGModel(red=red, blue=blue, **MRTCG_KW).init_state(
        mp.init_rho_cosine(R, C, red.rho_0, True, 1.0),
        mp.init_rho_cosine(R, C, blue.rho_0, False, 1.0), dtype=dtype, device=cuda)
    csf = surface_tension == "csf"
    S = torch.cat([st.red.f, st.blue.f] + ([torch.zeros((2, R, C), dtype=dtype, device=cuda)]
                                           if csf else []))
    G = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C), surface_tension)
    kw = dict(dtype=dtype, surface_tension=surface_tension, substeps=substeps, **MRTCG_KW)
    with pytest.raises(ValueError, match="wider than 2C"):
        mrtcg.make_mrtcg_reduced_lanes_step(R, C, red, blue, lane_block=C,
                                            **dict(kw, substeps=substeps + 1))
    before = mrtcg.MRTCG_REDUCED_LANES.launches
    got = mrtcg.make_mrtcg_reduced_lanes_step(R, C, red, blue, lane_block=C, **kw)(G)
    torch.cuda.synchronize()
    assert mrtcg.MRTCG_REDUCED_LANES.launches - before == substeps
    want = mrtcg.make_mrtcg_reduced_step(R, C, red, blue, **kw)(G)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.cuda
def test_lanes_kernel_rejects_what_it_does_not_take(cuda):
    """The wrapper raises on a tensor kernel 39 does not take, and a launch
    the C side refuses (a margin narrower than one sweep) raises."""
    from lbm_tpu_torch.kernels import _build, mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    params = mrtcg.kernel_params(mp.DEFAULT_RED, mp.DEFAULT_BLUE, 1e-4, (0.0, 0.0), 0.1, True)
    S = torch.zeros((10, 8, 256), dtype=torch.float64, device=cuda)

    def launch(x, lane_block=128):
        return mrtcg.launch_mrtcg_lanes(x, params, False, lane_block, 2)

    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(S.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(S[:, :, ::2])
    with pytest.raises(TypeError):
        launch(S.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(10, R, C\)"):
        launch(S[:9].contiguous())
    with pytest.raises(ValueError, match="lane blocks dividing"):
        launch(S, lane_block=96)
    with pytest.raises(ValueError, match="wider than 2C"):
        mrtcg.launch_mrtcg_lanes(torch.zeros((10, 8, 4), dtype=torch.float64, device=cuda),
                                 params, False, 4, 1)
    out = torch.empty_like(S)
    with pytest.raises(RuntimeError, match="lbm_mrtcg_reduced_lanes: launch failed"):
        mrtcg.MRTCG_REDUCED_LANES.launch(S.data_ptr(), out.data_ptr(), 8, 256, 128, 1, 1, 1,
                                         _build.c_doubles(params), 0, 1,
                                         _build.stream_handle(S))


# --- the MRT-CG engines' edges (csrc/mrtcg.cuh; kernels 6-8, 29, 31, 38, 39) ---
#
# A launch takes the strip or the tile engine by its plan (csrc/strip_plan.cuh);
# these tests force each in turn (lbm_mrtcg_force_engine), so both are held at
# every shape, and the plan's own choice at the shapes the other tests use.

ENGINES = {"tile": 1, "strip": 2}


@pytest.fixture(params=list(ENGINES))
def engine(request, cuda):
    """Every MRT-CG launch of the test on one engine; the plan's choice after."""
    from lbm_tpu_torch.kernels import _build

    force = _build.library().lbm_mrtcg_force_engine
    force.argtypes, force.restype = [ctypes.c_int], ctypes.c_int
    force(ENGINES[request.param])
    yield request.param
    force(0)

EDGE_R = (4, 5, 13, 21, 100, 257)
EDGE_C = (3, 13, 33, 100, 129, 2050)


def _flat_mrtcg(layout, R, C, dtype, surface_tension, device):
    """(kernel step, plain step, input, kernel) of kernel 6 (reduced), 7
    (split) or 8 (full) from a seeded two-phase state."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    csf = surface_tension == "csf"
    S = _two_phase_state(R, C, dtype, device, surface_tension, seed=R * C + 7)
    plain = mrtcg.make_plain_step(red, blue, surface_tension=surface_tension,
                                  reduced_in=layout != "full",
                                  reduced_out=layout == "reduced", **MRTCG_KW)
    if layout == "full":
        make = mrtcg.make_csf_fused_step if csf else mrtcg.make_mrtcg_fused_step
        full = make(R, C, red, blue, dtype=dtype, **MRTCG_KW)
        step = lambda x: full(x if csf else x.reshape(2, 9, R, C)).reshape(-1, R, C)  # noqa: E731
        return step, plain, S, mrtcg.MRTCG_FULL
    factory = (mrtcg.make_mrtcg_reduced_step if layout == "reduced"
               else mrtcg.make_mrtcg_split_step)
    step = factory(R, C, red, blue, dtype=dtype, surface_tension=surface_tension, **MRTCG_KW)
    x = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C), surface_tension)
    kernel = mrtcg.MRTCG_REDUCED if layout == "reduced" else mrtcg.MRTCG_SPLIT
    return (lambda y: step(y).reshape(-1, R, C)), plain, x, kernel


def _hold_bit_for_bit(step, plain, x, kernel, steps):
    before = kernel.launches
    got, want = x, x
    for _ in range(steps):
        got, want = step(got), plain(want)
    torch.cuda.synchronize()
    assert kernel.launches - before == steps
    assert got.is_cuda and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", EDGE_C)
@pytest.mark.parametrize("R", EDGE_R)
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strip_engine_reduced_edges_bit_for_bit(cuda, engine, dtype, surface_tension, R, C):
    """Kernel 6 on each engine at the edge shapes (a ragged last strip or
    tile, one strip narrower than the window, R = 4, segments of one group),
    two steps: bit for bit its plain version."""
    _hold_bit_for_bit(*_flat_mrtcg("reduced", R, C, dtype, surface_tension, cuda), steps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", list(zip(EDGE_R, EDGE_C)) + [(257, 3), (4, 2050)])
@pytest.mark.parametrize("layout", ["split", "full"])
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strip_engine_split_and_full_edges_bit_for_bit(cuda, engine, dtype, surface_tension,
                                                        layout, R, C):
    """Kernels 7 (one step) and 8 (two) on each engine at the edge shapes:
    bit for bit their plain versions."""
    _hold_bit_for_bit(*_flat_mrtcg(layout, R, C, dtype, surface_tension, cuda),
                      steps=1 if layout == "split" else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("family,n,s", [(f, n, s) for f, cap in (
    ("mrtcg", 5), ("csf", 4), ("mrtcg full", 5), ("csf full", 4))
    for n in (1, 2, 8) for s in (1, cap)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strip_engine_row_shards_match_single_device(cuda, engine, family, n, s, dtype):
    """Kernels 29 (reduced) and 31 (full) on each engine, n row shards of one
    card with s up to the cap, at 129 columns (three strips, the last
    ragged): 0.0 against kernels 6 and 8."""
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 192, 129
    fam, full = family.split()[0], family.endswith("full")
    make = _k31_33_case if full else _sharded_case
    step, single, x, kernels = make(fam, R, C, dtype, cuda, n, s)
    mesh = pm.make_mesh([cuda] * n)
    before = [k.launches for k in kernels]
    got = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    torch.cuda.synchronize()
    assert sum(k.launches for k in kernels) - sum(before) == 2 * n * s
    assert torch.equal(got, single(single(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("family,shape,s", [(f, m, s) for f, cap in (("mrtcg", 2), ("csf", 1))
                                            for m in ((1, 2), (4, 2), (2, 4))
                                            for s in sorted({1, cap})])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strip_engine_meshes_match_single_device(cuda, engine, family, shape, s, dtype):
    """Kernel 38 on each engine, the (1, 2), (4, 2) and (2, 4) meshes of one
    card at 100 columns (shards of 50 and 25 columns, one strip each): 0.0
    against kernel 8."""
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = 64, 100
    step, single, x, kernel = _k35_38_case(family, R, C, dtype, cuda, shape, s)
    mesh = pm.make_mesh([cuda] * (shape[0] * shape[1]), shape)
    before = kernel.launches
    got = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    torch.cuda.synchronize()
    assert kernel.launches - before == 2 * shape[0] * shape[1] * s
    assert torch.equal(got, single(single(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,lane_block", [(5, 256, 128), (5, 256, 256), (13, 384, 128)])
@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strip_engine_lanes_match_kernel_6(cuda, engine, dtype, surface_tension, substeps, R,
                                           C, lane_block):
    """Kernel 39 on each engine at small R and lane blocks 128, 256 and C:
    bit for bit kernel 6 run ``substeps`` times."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    csf = surface_tension == "csf"
    S = _two_phase_state(R, C, dtype, cuda, surface_tension, seed=R + C + lane_block)
    G = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C), surface_tension)
    kw = dict(dtype=dtype, surface_tension=surface_tension, substeps=substeps, **MRTCG_KW)
    got = mrtcg.make_mrtcg_reduced_lanes_step(R, C, red, blue, lane_block=lane_block, **kw)(G)
    want = mrtcg.make_mrtcg_reduced_step(R, C, red, blue, **kw)(G)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _instances(unit):
    """csrc/mrtcg.cuh describe_unit of one unit, every instance: (float64,
    CSF, memory, the strip kernel's and the tile kernel's registers, local
    bytes, shared memory, threads, blocks an SM)."""
    from lbm_tpu_torch.kernels import _build

    fn = getattr(_build.library(), f"lbm_mrtcg_{unit}_instances")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    rows = []
    while True:
        out = (ctypes.c_longlong * 13)()
        rc = fn(len(rows), out)
        if rc == -1:
            return rows
        assert rc == 0, f"{unit} instance {len(rows)}: cudaError_t {rc}"
        rows.append((out[10], out[11], out[12], tuple(out[0:5]), tuple(out[5:10])))


@pytest.mark.cuda
@pytest.mark.parametrize("unit,count", [("reduced", 16), ("split", 4), ("full", 20)])
def test_engine_instances_fit_the_card(cuda, unit, count):
    """Every instance of both engines in each unit: no local memory (no
    spill), its shared memory within the card's opt-in limit, and at least
    one block an SM by the card's occupancy calculator (two of the strip's in
    float32, which __launch_bounds__ asks of ptxas)."""
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    rows = _instances(unit)
    assert len(rows) == count
    for f64, csf, mem, strip, tile in rows:
        for regs, local, smem, threads, blocks in (strip, tile):
            assert regs > 0 and local == 0 and 0 < smem <= limit and blocks >= 1
        assert strip[3] == 256 // (1 + f64) and tile[3] == 256
        assert strip[4] >= (1 if f64 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_on_the_card(cuda, itemsize):
    """The plan with the card's own residency (the flat instance's strip
    kernel): kernel 6 at 4096x2048 on the strip engine in both modes, at
    the scenes' grids on the tile, and the strip plan within the blocks the
    card holds or two waves of its SMs."""
    from lbm_tpu_torch.kernels import _build

    fn = _build.library().lbm_mrtcg_plan
    fn.argtypes = [ctypes.c_longlong] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    flat = {(f64, csf): strip for f64, csf, mem, strip, _ in _instances("reduced") if mem == 0}
    for csf in (0, 1):
        held = flat[(int(itemsize == 8), csf)][4] * sms

        def plan(width, nrows):
            out = (ctypes.c_longlong * 7)()
            fn(width, nrows, held, sms, 1, 0, csf, int(itemsize == 8), 1, 1, out)
            return tuple(out)
        big = plan(2048, 4096)
        assert big[6] == 1 and big[4] <= max(held, 2 * sms)
        for R, C in ((256, 128), (128, 128), (100, 100), (21, 13)):
            assert plan(C, R)[6] == 0


# --- kernel 12 (csrc/rk_cg.cu), kernel 36's shard batches, F1 ------------------

# the RK scene's grid, the big grid, ragged grids (R, C not multiples of a
# tile, C < 62) and the smallest
RK_GRIDS = [(1024, 256), (4096, 2048), (37, 29), (203, 61), (4, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C", RK_GRIDS)
def test_rk_kernel_matches_plain_bit_for_bit(cuda, dtype, R, C):
    """Kernel 12, 2 steps (one launch each) from the RT state: bit for bit
    its plain version (both round each operation once, in the same
    order)."""
    from lbm_tpu_torch.kernels import rk

    S = _rk_state(R, C, dtype, cuda)
    before = rk.RK_CG.launches
    got = rk.make_rk_fused_step(R, C, dtype=dtype, substeps=2, **RK_KW)(S)
    torch.cuda.synchronize()
    assert rk.RK_CG.launches - before == 2
    plain = rk.make_plain_step(**RK_KW)
    assert torch.equal(got, plain(plain(S)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", [("rows", 8), ("rows", 2), ("rows x cols", (4, 2)),
                                  ("rows x cols", (2, 4))])
def test_rk_halo_kernels_match_kernel_12(cuda, dtype, case):
    """Kernels 30 (row shards) and 37 (rows x cols shards), two calls: 0.0
    against kernel 12; each a launch a call over up to MAX_SHARDS shards of
    the card."""
    from lbm_tpu_torch.parallel import mesh as pm

    kind, n = case
    if kind == "rows":
        R, C = 192, 40
        step, single, x, kernels = _sharded_case("rk", R, C, dtype, cuda, n, 1)
        mesh = pm.make_mesh([cuda] * n)
    else:
        R, C = 64, 96
        step, single, x, kernel = _k35_38_case("rk", R, C, dtype, cuda, n, 1)
        mesh, kernels = pm.make_mesh([cuda] * (n[0] * n[1]), n), [kernel]
    before = sum(k.launches for k in kernels)
    got = step(step(pm.shard_state(mesh, x))).gather().reshape(x.shape)
    torch.cuda.synchronize()
    assert sum(k.launches for k in kernels) - before == 2
    assert torch.equal(got, single(single(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [0, 1])
def test_rk_kernel_fits_the_card(cuda, f64):
    """Kernel 12's flat instance spills nothing and fits an SM, r_rho / rho
    on its window and its ring values in shared memory, in float64 (the
    staged tile) the window's two colour densities too (csrc/rk_cg.cu
    smem_bytes)."""
    from lbm_tpu_torch.kernels import _build

    fn = _build.library().lbm_rk_describe
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    assert fn(f64, out) == 0
    regs, local, smem, threads, per_sm = out
    window, ring = (8 + 6) * (32 + 6 + 3), 18 * (8 + 2) * (32 + 2)
    assert local == 0 and threads == 256 and per_sm >= 1
    assert smem == (8 * (3 * window + ring) if f64 else 4 * (window + ring))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,mesh_shape,s", [((64, 128), (4, 2), 8), ((64, 128), (4, 4), 3),
                                                ((128, 64), (8, 2), 1), ((64, 96), (1, 2), 8)])
def test_kernel_36_batches_match_single_device(cuda, dtype, shape, mesh_shape, s):
    """Kernel 36 on an (nx, ny) mesh of one card's shards, one launch a sweep
    over up to MAX_SHARDS shards (16 shards: two a sweep), three calls: bit
    for bit kernel 23 run as many steps, within TOL of the plain rows x cols
    version; the rayleigh_benard gate's 64x128 on (4, 2) with 8 sweeps a call
    among them."""
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    R, C = shape
    step, single, x, kernel = _k35_38_case("thermal", R, C, dtype, cuda, mesh_shape, s)
    mesh = pm.make_mesh([cuda] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    before = kernel.launches
    got = pm.shard_state(mesh, x)
    plain = pm.shard_state(mesh, x)
    want = x
    for _ in range(3):
        got, plain, want = step(got), step.plain(plain), single(want)
    torch.cuda.synchronize()
    n = mesh_shape[0] * mesh_shape[1]
    assert kernel.launches - before == 3 * s * -(-n // k2d.MAX_SHARDS)
    got, plain = got.gather(), plain.gather()
    assert got.is_cuda and torch.equal(got, want)
    assert (got - plain).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_36_rejects_a_batch_it_cannot_take(cuda):
    """The batched launch refuses more than MAX_SHARDS shards and none."""
    from lbm_tpu_torch.kernels import _build, thermal
    from lbm_tpu_torch.kernels import sharded2d as k2d

    params = thermal.thermal_constants(1.0, 1.25, 1e-4, torch.float32)
    geoms = (ctypes.c_longlong * (len(k2d.GEOM) * (k2d.MAX_SHARDS + 1)))()
    fn = _build.library().lbm_halo2d_thermal
    fn.argtypes, fn.restype = k2d.HALO2D_THERMAL.argtypes, ctypes.c_int
    for n in (0, k2d.MAX_SHARDS + 1):
        assert fn(geoms, params, n, 0, 0, None) != 0


@pytest.mark.cuda
def test_moving_bodies_window_past_65535_columns(cuda):
    """Kernel 21 on a 128x65600 grid, its window 116 rows by all 65,600
    columns (past the 16-bit column packing the live list had): 3 steps
    against the plain step in float64, F within TOL, the origin equal, the
    state within TOL of max(1, |value|)."""
    from lbm_tpu_torch.kernels import moving_ibm as km

    H, W = 128, 65600
    th = np.linspace(0.0, 2.0 * np.pi, 76, endpoint=False)
    step = km.make_moving_bodies_step(H, W, 12 * np.cos(th), 12 * np.sin(th), n_bodies=2,
                                      rw=116, half=17, g_net=2.262e-2, m_eff=565.5,
                                      radius=12.0, dtype=torch.float64)
    state = km.pack_states(((50.0, 40000.0), (75.0, 40001.0)), ((0.003, 0.0), (0.004, 0.0005)),
                           dtype=torch.float64, device=cuda)
    f = _noisy_state(H, W, torch.float64, cuda, seed=65600)
    before = km.MOVING_BODIES.launches
    got, want = state, state
    for _ in range(3):
        Fg, og, got = step(f, got)
        Fw, ow, want = step.plain(f, want)
    torch.cuda.synchronize()
    assert km.MOVING_BODIES.launches - before == 3 and Fg.shape == (2, 116, W)
    assert og.tolist() == ow.tolist() and (Fg - Fw).abs().max().item() <= TOL[torch.float64]
    assert (Fg[0] != 0).sum().item() > 0
    assert _state_err(got, want) <= TOL[torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("walls", ["periodic", "cavity", "channel"])
@pytest.mark.parametrize("n,s", [(1, 1), (2, 3), (4, 8), (8, 2), (16, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_33_batches_match_kernel_25(cuda, monkeypatch, dtype, n, s, walls):
    """Kernel 33 on n shards of one card, one launch a sweep over up to
    MAX_SHARDS shards (16: two a sweep), the first sweep reading the
    neighbours' rows in place, two calls: bit for bit kernel 25 run as many
    steps, no exchange copy; the same step reading exchanged copies of the
    rows (``exchange_rows``) gives the same bits."""
    from lbm_tpu_torch.kernels import _build, d3q19
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm

    X, Y, Z = 3, 8 * n if n > 4 else 48, 40
    kw = dict(omega=1.0 / 0.7, substeps=s, dtype=dtype, **D3Q19_WALLS[walls])
    mesh = pm.make_mesh([cuda] * n)
    f = _d3q19_state(X, Y, Z, dtype, cuda, seed=330 + n + s)
    x = pm.shard_state(mesh, f.reshape(19 * X, Y, Z))
    step = ksh.make_sharded_d3q19_step(mesh, X, Y, Z, **kw)
    one = d3q19.make_d3q19_fused_step(X, Y, Z, **kw)
    copies, copy_to = [], ph.copy_to
    monkeypatch.setattr(ph, "copy_to", lambda src, d: copies.append(1) or copy_to(src, d))
    before = ksh.HALO_D3Q19.launches
    got = step(step(x)).gather()
    torch.cuda.synchronize()
    assert ksh.HALO_D3Q19.launches - before == 2 * s * -(-n // _build.MAX_SHARDS)
    assert not copies
    assert torch.equal(got.reshape(f.shape), one(one(f)))
    monkeypatch.setattr(ksh, "ring_rows", ph.exchange_rows)
    exchanged = ksh.make_sharded_d3q19_step(mesh, X, Y, Z, **kw)
    assert torch.equal(exchanged(exchanged(x)).gather(), got) and len(copies) == 4 * n


@pytest.mark.cuda
def test_kernel_33_rejects_a_batch_it_cannot_take(cuda):
    """The batched launch refuses more than MAX_SHARDS shards and none, and
    its wrapper raises on the refusal."""
    from lbm_tpu_torch.kernels import _build, d3q19
    from lbm_tpu_torch.kernels import sharded as ksh

    params = d3q19.d3q19_constants(1.0, 0.0, 0.0, torch.float32)
    geoms = (ctypes.c_longlong * (len(ksh.GEOM) * (_build.MAX_SHARDS + 1)))()
    fn = _build.library().lbm_halo_d3q19
    fn.argtypes, fn.restype = ksh.HALO_D3Q19.argtypes, ctypes.c_int
    for n in (0, _build.MAX_SHARDS + 1):
        assert fn(geoms, params, n, 2, 0, 0, None) != 0
    before = ksh.HALO_D3Q19.launches
    with pytest.raises(RuntimeError, match="lbm_halo_d3q19: launch failed"):
        ksh.HALO_D3Q19.launch(geoms, params, _build.MAX_SHARDS + 1, 2, 0, 0, None)
    assert ksh.HALO_D3Q19.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(128, 128), (4096, 2048), (37, 29), (4, 2)])
def test_kernel_4_sized_launch_matches_plain(cuda, dtype, shape):
    """Kernel 4 with blocks sized to the card, a programmatic dependent
    launch where the grid fits in one wave (128x128, 37x29, 4x2), 3 steps:
    one launch a step, within TOL of kbc_channel_step; a CUDA graph of the
    steps gives the same bits."""
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=R + C, noisy=True)
    args = (KBC_S2, 1.001, 1.0)
    step = channel.make_channel_fused_step(R, C, *args, dtype, family="kbc")
    before = channel.CHANNEL_KBC.launches
    got = step(step(step(f)))
    torch.cuda.synchronize()
    assert channel.CHANNEL_KBC.launches - before == 3
    plain = channel.kbc_channel_step(*args)
    assert (got - plain(plain(plain(f)))).abs().max().item() <= TOL[dtype]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step(step(step(f)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(128, 128), (4096, 2048), (37, 29), (4, 2)])
def test_kernel_2_sized_launch_matches_plain(cuda, dtype, shape):
    """Kernel 2 with blocks sized to the card, a programmatic dependent
    launch where the grid fits in one wave (128x128, 37x29, 4x2), a virtual
    row's thread colliding only its source, 3 steps: one launch a step,
    within TOL of channel_model(...).step; a CUDA graph of the steps gives
    the same bits."""
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=R + C + 2, incompressible=True, noisy=True)
    args = (1.0 / TAU_MAGIC, 1.001, 1.0)
    step = channel.make_channel_fused_step(R, C, *args, dtype)
    before = channel.CHANNEL_BGK.launches
    got = step(step(step(f)))
    torch.cuda.synchronize()
    assert channel.CHANNEL_BGK.launches - before == 3
    plain = channel.channel_model(*args).step
    assert (got - plain(plain(plain(f)))).abs().max().item() <= TOL[dtype]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step(step(step(f)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(128, 128), (4096, 2048), (37, 29), (4, 4)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_9_sized_launch_matches_plain(cuda, name, dtype, shape):
    """Kernel 9 in every variant with blocks sized to the card, a
    programmatic dependent launch where the grid fits in one wave (128x128,
    37x29, 4x4), a virtual line's thread colliding only its source and the
    wall tests only near a wall line, 3 steps: one launch a step, within TOL
    of the plain model step; a CUDA graph of the steps gives the same bits."""
    kw = VARIANTS[name]
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=R + C + 9, incompressible=kw["incompressible"],
               noisy=True)
    step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
    before = channel.CHANNEL_VARIANT.launches
    got = step(step(step(f)))
    torch.cuda.synchronize()
    assert channel.CHANNEL_VARIANT.launches - before == 3
    plain = channel.ChannelVariant(**kw).model().step
    assert (got - plain(plain(plain(f)))).abs().max().item() <= TOL[dtype]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step(step(step(f)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)
