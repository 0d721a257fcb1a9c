"""The refinement at every width the JAX kernels take, on the CPU.

`ModelConfig.refine_channels` is a field of both packages, and the JAX
rows and planar kernels take any width. Here: the refinement's route rule
(`refine_kernels.refine_routes`) gives every (dtype, engine, width) a
route and layouts that chain from launch to launch with no copy, and is
what `refine_residual` asks each launch for; the port's kernel path (each
kernel's plain version) matches JAX's kernel path (Pallas in interpret
mode) at refine_channels 48 and 20 under all five engines; `layer_plan`
pairs the dw-sep layers as the JAX chunk rule pairs them at the width, and
raises where JAX raises; and the B images of `conv3d_bn_relu`'s 16-, 32-
and 64-output tensor-core route hold the weights where the kernel reads
them. float32 throughout; the kernels themselves run on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py` phase 14).
"""

import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lwsnet_tpu.models import refine_pallas  # noqa: E402
from lwsnet_tpu.ops.pallas import refine as K  # noqa: E402
from lwsnet_tpu_torch import LWSNet, ModelConfig  # noqa: E402
from lwsnet_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                      to_jax_variables)
from lwsnet_tpu_torch.models import refine_kernels as RK  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import costfilter as tcf  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import refine as T  # noqa: E402
from lwsnet_tpu_torch.ops.cuda import refine_rows as trr  # noqa: E402
from lwsnet_tpu_torch.tools import parity_layers as PL  # noqa: E402
from lwsnet_tpu_torch.tools.parity_layers import ENGINES  # noqa: E402
from test_torch_model import _span_check, jitter  # noqa: E402

WIDTHS = (3, 16, 20, 32, 48, 64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's small convolutions: beside the
    other test workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = (torch.bfloat16, torch.float32)
# The layer functions refine_kernels calls, each a launch, by kernel.
LAUNCHERS = {"dense_layer": "dense3x3", "dense2_layer": "dense3x3",
             "fused_dense": "dense3x3", "dwsep_layer": "dwsep3x3",
             "fused_dwsep": "dwsep3x3", "dwsep2_layer": "dwsep3x3_pair",
             "fused_dwsep2": "dwsep3x3_pair", "chain_layer": "chain3x3"}


def _route(dtype, name, args, kwargs):
    """The route a launch of layer function `name` takes on the card, from
    its operands and the wrappers' own predicates."""
    x = args[0]
    if name == "chain_layer":
        ks, two = args[1], kwargs.get("two_input", False)
        cis = [k.shape[-3] // (2 if two and i == 0 else 1)
               for i, k in enumerate(ks)]
        tc = trr.chain_tensor_core_route(
            dtype, cis, [k.shape[-4] for k in ks], kwargs["dilations"],
            kwargs.get("groups", 1), two)
        return tcf.TENSOR_CORES if tc else tcf.CUDA_CORES
    if "dwsep" in name:
        pair = "dwsep2" in name
        dils = ((kwargs["dilation1"], kwargs["dilation2"]) if pair
                else (kwargs["dilation"],))
        c = x.shape[1]
        return trr.dwsep_route(dtype, (c,) * (len(dils) + 1), dils,
                               kwargs.get("groups", 1))
    kern = args[1]
    if name == "fused_dense":  # HWIO
        ci, co = kern.shape[2], kern.shape[3]
    else:
        co, ci = kern.shape[-4], kern.shape[-3]
    inputs = 2 if name == "dense2_layer" else 1
    ci //= inputs
    rule = (dtype, ci, co, kwargs["dilation"], inputs,
            kwargs.get("groups", 1))
    if trr.dense_entry_route(*rule):
        return RK.ENTRY
    if trr.dense_output_route(*rule):
        return RK.OUTPUT
    if trr.dense_f32_route(*rule):
        return trr.F32
    return (tcf.TENSOR_CORES if trr.dense_tensor_core_route(*rule)
            else tcf.CUDA_CORES)


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_rule_is_what_the_refinement_asks_for(dtype, monkeypatch):
    """For each engine and width of WIDTHS: the rule's launches chain with
    no layout copy (`layout_copies`), the kernels the rule lists are the
    ones `refine_residual` launches, in order, each on the route its
    operands' shapes give, each asked to write the layout the rule says;
    `parity_layers.refine_plan` records the same routes; and chip_smoke's
    launch and narrow-route counts (bf16) are the rule's."""
    calls = []

    def recorder(name, original):
        def wrapper(*args, **kwargs):
            calls.append((LAUNCHERS[name], _route(dtype, name, args, kwargs),
                          kwargs.get("channels_last")))
            return original(*args, **kwargs)
        return wrapper

    for name in LAUNCHERS:
        monkeypatch.setattr(RK, name, recorder(name, getattr(RK, name)))
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.standard_normal((1, 16, 24, 3)).astype(
        np.float32))
    disp = torch.from_numpy(rng.uniform(0, 9, (1, 16, 24, 1)).astype(
        np.float32))
    for c in WIDTHS:
        model = LWSNet(ModelConfig(refine_channels=c), device="cpu")
        for engine, fields in ENGINES.items():
            rule = RK.refine_routes(dtype, engine, c, 16, 24)
            assert RK.layout_copies(rule) == 0, (c, engine)
            calls.clear()
            with torch.no_grad():
                out = RK.refine_residual(
                    model, left, disp, dtype=dtype,
                    mode=fields.get("pallas_mode", "rows"),
                    dw=fields.get("rows_dw", "vpu"),
                    paired=fields.get("rows_paired", True))
            assert out.shape == (1, 16, 24, 1), (c, engine)
            # "chain" launches write what their route fixes (no argument)
            want = [(L.kernel, L.route, None if L.kernel == "chain3x3"
                     else L.writes_cl) for L in rule]
            assert calls == want, (c, engine)
            # the per-launch check records the same routes
            dt = str(dtype).replace("torch.", "")
            assert [L.kernel_route[dt] for L in PL.refine_plan(
                model.cfg, engine, 16, 24)] == [L.route for L in rule]
            if dtype != torch.bfloat16:  # chip_smoke counts bf16 forwards
                continue
            launches, routes = chip_smoke.refine_launches(
                engine, dict(refine_channels=c), 16, 24)
            counts = {}
            for L in rule:
                counts[L.kernel] = counts.get(L.kernel, 0) + 1
            assert {k: v for k, v in launches.items()
                    if "[" not in k} == counts
            want_routes = {}
            for L in rule:
                if L.route in (RK.ENTRY, RK.OUTPUT, trr.MMA):
                    key = f"{L.kernel}[{L.route}]"
                    want_routes[key] = want_routes.get(key, 0) + 1
            assert routes == want_routes
    with pytest.raises(ValueError, match="engine"):
        RK.refine_routes(dtype, "vpu", 32)


def test_route_rule_at_the_shipped_width():
    """bf16 at 32 channels: channels-last from the entries to the output
    conv on every engine, each launch on its tensor-core or narrow route;
    off the tensor-core widths every dw-sep layer on `dwsep3x3`'s tile
    body (route MMA) and every dense layer on the CUDA cores,
    channels-last only into an output conv that reads it."""
    bf = torch.bfloat16
    for engine in ENGINES:
        rule = RK.refine_routes(bf, engine, 32)
        assert all(L.route not in (tcf.CUDA_CORES, trr.MMA)
                   for L in rule), engine
        assert [L.writes_cl for L in rule[:-1]] == [True] * (len(rule) - 1)
    for c in (20, 48):
        for engine in ENGINES:
            rule = RK.refine_routes(bf, engine, c)
            assert rule[-2].writes_cl == rule[-1].reads_cl == (
                c % 16 == 0 and engine != "chain"), (c, engine)
            assert all(L.route == (trr.MMA if L.kernel.startswith("dwsep")
                                   else tcf.CUDA_CORES)
                       for L in rule[:-1])


def test_dwsep_route_names_the_tile_body():
    """`dwsep_route` is the wgmma route where `dwsep_tensor_core_route`
    takes the shape, else `dwsep3x3`'s tile body: MMA in bf16, the CUDA
    cores in float32; `refine_routes` names each dw-sep launch of the
    "vpu" and "layers" engines so at every width 1-64 (the tile body off
    32 channels in bf16, everywhere in float32), with no layout copy; and
    chip_smoke counts the tile body's launches as `build.route_counts()`
    does ("[mma]", "[cores]")."""
    bf, f32 = torch.bfloat16, torch.float32
    for chans, dils, g, want in (
            ((16, 32), (16,), 2, tcf.TENSOR_CORES),
            ((32, 32, 32), (8, 16), 2, tcf.TENSOR_CORES),
            ((32, 32), (17,), 1, trr.MMA), ((32, 32), (1,), 3, trr.MMA),
            ((48, 48, 48), (8, 16), 2, trr.MMA), ((20, 20), (2,), 2, trr.MMA),
            ((32, 8), (1,), 1, trr.MMA)):
        assert trr.dwsep_route(bf, chans, dils, g) == want, chans
        assert (want == tcf.TENSOR_CORES) == trr.dwsep_tensor_core_route(
            bf, chans, dils, g)
        assert trr.dwsep_route(f32, chans, dils, g) == tcf.CUDA_CORES
    for c in range(1, 65):
        for dtype in DTYPES:
            for engine in ("vpu-paired", "vpu-unpaired", "layers"):
                rule = RK.refine_routes(dtype, engine, c)
                assert RK.layout_copies(rule) == 0, (c, engine)
                routes = {L.route for L in rule
                          if L.kernel.startswith("dwsep")}
                want = (tcf.TENSOR_CORES if dtype == bf and c == 32
                        else trr.MMA if dtype == bf else tcf.CUDA_CORES)
                assert routes == {want}, (c, dtype, engine, routes)
                assert all(not L.reads_cl for L in rule
                           if L.route in (trr.MMA, tcf.CUDA_CORES)
                           and L.kernel.startswith("dwsep"))
    for dtype, name in ((bf, "mma"), (f32, "cores")):
        for kernel, p in (("dwsep3x3", dict(C=48, d=16, G=2)),
                          ("dwsep3x3_pair", dict(C=20, d1=8, d2=16, G=2))):
            assert chip_smoke.dwsep_route_launches(kernel, p, dtype) == {
                f"{kernel}[{name}]": 1}
    assert chip_smoke.dwsep_route_launches(
        "dwsep3x3_pair", dict(C=16, Co=32, d1=1, d2=16, G=2), bf) == {}


@pytest.mark.parametrize("c", [48, 20])
def test_refinement_widths_match_jax(c):
    """The stage-4 residual at refine_channels c under each of the five
    engines at 32x64: the port's `refine_residual` (each kernel's plain
    version) against the JAX package's `refine_pallas.refine_residual`
    with its Pallas kernels in interpret mode, on the same jittered
    weights, at the whole-model bar of tests/test_torch_inference.py
    (`_span_check`)."""
    rng = np.random.default_rng(c)
    model = LWSNet(ModelConfig(compute_dtype="float32", refine_channels=c),
                   device="cpu")
    variables = jitter(to_jax_variables(model.state_dict()), rng)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    left = rng.standard_normal((1, 32, 64, 3)).astype(np.float32)
    disp = rng.uniform(0, 20, (1, 32, 64, 1)).astype(np.float32)
    for engine, fields in ENGINES.items():
        mode = fields.get("pallas_mode", "rows")
        dw = fields.get("rows_dw", "vpu")
        paired = fields.get("rows_paired", True)
        want = jax.jit(functools.partial(
            refine_pallas.refine_residual, dtype=jnp.float32,
            interpret=True, mode=mode, dw=dw, paired=paired))(
            variables, jnp.asarray(left), jnp.asarray(disp))
        with torch.no_grad():
            got = RK.refine_residual(model, torch.from_numpy(left),
                                     torch.from_numpy(disp), mode=mode,
                                     dw=dw, paired=paired)
        _span_check([got], [want])


def _jax_plan(h, w, dilations, channels, monkeypatch):
    """The launches the JAX `_dwsep_chain` makes at h x w with the chunk
    `refine_pallas.refine_residual` picks for `channels`, recorded."""
    steps = []

    def pair(y, *args, dilation1, dilation2, **kw):
        steps.append((dilation1, dilation2))
        return y

    def solo(y, *args, dilation, **kw):
        steps.append((dilation,))
        return y

    monkeypatch.setattr(K, "fused_dwsep2", pair)
    monkeypatch.setattr(K, "fused_dwsep", solo)
    chunk = K.pick_layer_chunk(h, w, channels)
    none = [None] * len(dilations)
    refine_pallas._dwsep_chain(None, none, none, none, dilations, chunk, h,
                               w, True)
    return tuple(steps)


@pytest.mark.parametrize("h,w", [(368, 1232), (368, 2560), (96, 3712)])
@pytest.mark.parametrize("channels", [32, 48, 64])
def test_layer_plan_follows_the_width(h, w, channels, monkeypatch):
    """`layer_plan` at the refinement's width pairs the layers the JAX
    chunk rule pairs at that width (48 channels on a 2560-wide image: the
    (8, 16) tower pair splits), and raises JAX's error where JAX finds no
    chunk (64 channels on a 3712-wide image)."""
    for dils in (refine_pallas.TOWER_DILATIONS,
                 refine_pallas.HEAD_DILATIONS):
        try:
            want = _jax_plan(h, w, dils, channels, monkeypatch)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                T.layer_plan(h, w, dils, channels)
            assert (channels, w) == (64, 3712)
            continue
        assert T.layer_plan(h, w, dils, channels) == want
    if (h, w, channels) == (368, 2560, 48):
        assert T.layer_plan(h, w, (2, 4, 8, 16), 48) == ((2, 4), (8,),
                                                          (16,))


@pytest.mark.parametrize("co", [16, 32, 64])
def test_conv3d_tensor_core_images(co):
    """`costfilter.tc_images`: each block's B images hold, for its
    32-channel output half, input-channel chunk and tap, weight
    wt[32 half + n, 16 chunk + k, tap] at the K-major core-matrix offset
    the kernel's descriptor reads (csrc/tc.cuh: core (n / 8, k / 8) at
    (n / 8) 256 + (k / 8) 128 bytes, a core row of 8 consecutive k), and
    zeros in the padded columns of 16 outputs; a block's images start
    at half x (Ci / 16) x 27 slices."""
    ci = co
    wt = torch.randn(co, ci, 3, 3, 3)
    flat = tcf.tc_images(wt).reshape(-1)
    padded = torch.cat([wt, wt.new_zeros(-co % 32, ci, 3, 3, 3)])
    n, k = torch.meshgrid(torch.arange(32), torch.arange(16), indexing="ij")
    offset = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8
    for half in range(padded.shape[0] // 32):
        for chunk in range(ci // 16):
            for tap in range(27):
                base = ((half * (ci // 16) + chunk) * 27 + tap) * 512
                want = padded[32 * half + n, 16 * chunk + k].reshape(
                    -1, 27)[:, tap].reshape(32, 16)
                assert torch.equal(flat[base + offset], want)
    assert flat.numel() == padded.shape[0] * ci * 27
