"""Which kernel ``repro_torch.kernels.lowrank.matmul`` launches on the card,
pinned on the CPU from ``meta`` tensors: each of PowerSGD's 33 products of
one full-width gpt2-paper step takes its streaming route, and every odd,
strided or misaligned call takes the general tiled kernel.  The kernels
themselves run only on the GPU (``test_torch_cuda.py``)."""
import jax
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.models import build_model as r_build_model

from repro_torch.configs import get_config
from repro_torch.core import build_plan
from repro_torch.kernels import lowrank
from repro_torch.models import build_model

RANK = 2


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _full_width_products():
    """``(leaf path, [(kind, a, b, trans_a, trans_b), ...])`` for every leaf
    PowerSGD factorises, chained as ``LowRank.execute_leaf`` chains them:
    P from ``torch.linalg.qr`` (column-major, as on the card), Q' a
    contiguous product."""
    plan = build_plan(build_model(get_config("gpt2-paper"), device="meta").named_leaves())
    out = []
    for path, shape in zip(plan.leaf_paths, plan.leaf_shapes):
        if len(shape) < 2:
            continue
        B = shape[0] if len(shape) == 3 else 1
        a, b = shape[-2:]
        M, Q = _meta(B, a, b), _meta(B, b, RANK)
        P, _ = torch.linalg.qr(_meta(B, a, RANK))
        Qn = _meta(B, b, RANK)
        out.append((path, [("P=M@Q", M, Q, False, False),
                           ("Q'=M^T@P", M, P, True, False),
                           ("P@Q'^T", P, Qn, False, True)]))
    return plan, out


def test_the_33_full_width_products_take_their_streaming_routes():
    plan, leaves = _full_width_products()
    # the same leaves as the reference's plan, so the same products
    rplan = r_build_plan(jax.eval_shape(r_build_model(rconfigs.get_config("gpt2-paper")).init,
                                        jax.random.PRNGKey(0)))
    assert [s for s in plan.leaf_shapes if len(s) >= 2] == \
        [tuple(s) for s in rplan.leaf_shapes if len(s) >= 2]
    want = {"P=M@Q": "rowdot", "Q'=M^T@P": "colacc", "P@Q'^T": "outer"}
    routes = {}
    for path, products in leaves:
        for kind, a, b, ta, tb in products:
            routes[(path, kind)] = lowrank.route(a, b, trans_a=ta, trans_b=tb)
    assert len(routes) == 33
    assert routes == {key: want[key[1]] for key in routes}


def _unaligned(*shape):
    """A meta tensor of ``shape`` that starts one float past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    return _meta(n + 1)[1:].view(shape)


@pytest.mark.parametrize(
    "a,b,kw",
    [
        (_meta(3, 1001, 517), _meta(3, 517, 3), {}),                # k % 4
        (_meta(3, 1001, 517), _meta(3, 517, 129), {}),              # n > 4
        (_meta(1, 64, 768), _meta(1, 768, 5), {}),                  # rank 5
        (_meta(2, 700, 1802)[:, :, ::2], _meta(2, 901, 2), {}),     # k stride 2
        (_meta(2, 700, 1802)[:, :, ::2], _meta(2, 700, 2),
         {"trans_a": True}),                                        # m stride 2
        (_meta(1, 64, 770)[:, :, :768], _meta(1, 768, 2), {}),      # row stride 770
        (_meta(1, 64, 770)[:, :, :768], _meta(1, 64, 2),
         {"trans_a": True}),
        (_unaligned(12, 768, 768), _meta(12, 768, 2), {}),          # base + 4 B
        (_unaligned(12, 768, 768), _meta(12, 768, 2), {"trans_a": True}),
        (_meta(2, 700, 2), _meta(2, 901, 2), {"trans_b": True}),    # n % 4
        (_meta(2, 700, 5), _meta(2, 768, 5), {"trans_b": True}),    # k = 5
        (_meta(1001, 517), _meta(517, 3), {}),                      # 2-D, k % 4
    ],
    ids=["odd-k", "wide", "rank-5", "strided-k", "strided-m", "row-stride",
         "row-stride-t", "misaligned", "misaligned-t", "odd-n", "k-5", "2d-odd"],
)
def test_odd_strided_and_misaligned_calls_take_the_tiled_kernel(a, b, kw):
    assert lowrank.route(a, b, **kw) == "tiled"


def test_two_dimensional_operands_route_as_one_batch():
    assert lowrank.route(_meta(768, 3072), _meta(3072, 2)) == "rowdot"
    assert lowrank.route(_meta(768, 3072), _meta(768, 2), trans_a=True) == "colacc"
    assert lowrank.route(_meta(768, 2), _meta(3072, 2), trans_b=True) == "outer"


def test_route_checks_the_operands_as_matmul_does():
    with pytest.raises(ValueError):
        lowrank.route(_meta(2, 3, 4), _meta(2, 5, 2))
    with pytest.raises(TypeError):
        lowrank.route(_meta(3, 4).double(), _meta(4, 2))


def test_cpu_calls_count_no_launch_on_any_route():
    before = dict(lowrank.matmul.launches_by_route)
    assert set(before) == set(lowrank.ROUTES) == {"rowdot", "colacc", "outer", "tiled"}
    M = torch.randn(2, 16, 8)
    lowrank.matmul(M, torch.randn(2, 8, 2))
    lowrank.matmul(M, torch.randn(2, 16, 2), trans_a=True)
    lowrank.matmul(torch.randn(2, 16, 2), torch.randn(2, 8, 2), trans_b=True)
    assert lowrank.matmul.launches_by_route == before
    assert sum(before.values()) == lowrank.matmul.launches
