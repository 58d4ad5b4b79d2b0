"""The ELL PageRank step kernel's plan (K2) and its route, on the CPU.

``ops/pagerank``'s plan of the operator (``build_ell_plan``), evaluated in
its own row schedule here (items in entry order, a wide slot's partial rows
in item order, as the kernel sums them), is held to ``_spmv_ell`` plus the
affine update of ``batched_ppr_ell``. The graph has every bucket width up
to 256, hubs spanning several 512-wide chunk rows, capacity padding rows
and zero-in-degree nodes. A CPU solve takes the torch step and launches
nothing; ``_KernelStep``, the solver's side of a kernel launch, is driven
here with the launch stubbed out. The kernel itself runs on the card in
``chip_smoke.py`` phase 10.
"""

import numpy as np
import pytest
import torch

from hipporag_tpu_torch.ops import pagerank as pr
from hipporag_tpu_torch.utils.timing import recording, span

torch.set_num_threads(1)

DAMPING = 0.5
U = 2.0**-24
HUB_DEGREES = (1_100, 1_600)  # 3 and 4 chunk rows of 512


def _layout_graph(seed=0, isolated=5, hubs=HUB_DEGREES, **ell):
    """Centre nodes whose in-degree lands in every bucket (of
    ``ell["bucket_widths"]``, the default ones without it) and ``hubs``,
    each joined to distinct leaves; the leaves take the small widths;
    ``isolated`` nodes have no edge. Returns (ELLGraph, num_nodes)."""
    rng = np.random.default_rng(seed)
    prev, degrees = 0, []
    for w in ell.get("bucket_widths", pr.DEFAULT_BUCKET_WIDTHS):
        degrees.append(int(rng.integers(prev + 1, w + 1)))
        prev = w
    degrees += list(hubs)
    centres = len(degrees)
    leaves = max(degrees) + 100
    src, dst = [], []
    for v, deg in enumerate(degrees):
        partners = centres + rng.choice(leaves, deg, replace=False)
        src.append(np.full(deg, v))
        dst.append(partners)
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    n = centres + leaves + isolated
    cap = -(-(n + 1) // 128) * 128
    s2, d2, w2, dang = pr.normalize_symmetric_coo(src, dst, w, n, cap)
    return pr.ell_from_coo(s2, d2, w2, dang, n, cap, **ell), n


@pytest.fixture(scope="module")
def graph():
    return _layout_graph()[0]


@pytest.fixture(scope="module")
def plan(graph):
    return pr.build_ell_plan(graph)


def _resets(graph, batch, seed):
    rng = np.random.default_rng(seed)
    n = int(graph.num_nodes)
    reset = np.zeros((batch, graph.local_inv.shape[0]), np.float32)
    for i in range(batch):
        reset[i, rng.choice(n, 5, replace=False)] = rng.uniform(0.1, 1.0, 5)
    return torch.from_numpy(reset)


def _slot_state(graph, reset, ld):
    r = pr._normalized_reset(reset, graph.num_nodes).T.contiguous()
    r_slot = torch.cat([r, r.new_zeros(1, r.shape[1])])[graph.slot_to_node]
    rdm = (r * graph.dangling[:, None]).sum(0)
    return torch.nn.functional.pad(r_slot, (0, ld - r.shape[1])).contiguous(), rdm.contiguous()


def _torch_step(graph, p, r, c, rdm, b, gather_dtype):
    """``batched_ppr_ell``'s torch step over the first b columns."""
    d = torch.tensor(DAMPING, dtype=torch.float32)
    y = pr._spmv_ell(graph, p[:, :b].contiguous(), pr._hub_rows(graph), gather_dtype)
    dm = c[None, :b] * rdm[None, :b]
    return (1.0 - d) * r[:, :b] + d * (y + dm * r[:, :b]), ((1.0 - d) + d * dm)[0]


def _exact_y(graph, p, b, gather_dtype):
    """T p in float64 from the ELL arrays (of the bfloat16-rounded state and
    weights for bf16 gathers), and the nonzero entries of each slot."""
    def rounded(x):
        return x.to(torch.bfloat16).double() if gather_dtype == torch.bfloat16 else x.double()

    src = rounded(p[:, :b])
    ys, ns = [], []
    for idx, wgt in zip(graph.bucket_idx, graph.bucket_wgt):
        ys.append((src[idx.long()] * rounded(wgt)[..., None]).sum(1))
        ns.append((wgt != 0).sum(1))
    n_hub = graph.hub_zero.shape[0]
    partial = (src[graph.hub_idx.long()] * rounded(graph.hub_wgt)[..., None]).sum(1)
    seg = graph.hub_seg.long()
    live = seg < n_hub
    ys.append(torch.zeros(n_hub, b, dtype=torch.float64).index_add_(0, seg[live], partial[live]))
    ns.append(torch.zeros(n_hub, dtype=torch.long).index_add_(0, seg[live], (graph.hub_wgt[live] != 0).sum(1)))
    ys.append(torch.zeros(1, b, dtype=torch.float64))
    ns.append(torch.zeros(1, dtype=torch.long))
    return torch.cat(ys), torch.cat(ns)


def test_graph_has_every_bucket_width_and_multi_chunk_hubs(graph):
    for width, wgt in zip(pr.DEFAULT_BUCKET_WIDTHS, graph.bucket_wgt):
        lens = torch.as_tensor(pr._row_lengths(wgt.numpy()))
        assert int(lens.max()) > (width // 2 if width > 16 else width - 1), width
        assert wgt.shape[0] > int((lens > 0).sum()), f"bucket {width} has no capacity row"
    chunks = torch.bincount(graph.hub_seg.long())[: len(HUB_DEGREES)]
    assert chunks.tolist() == [-(-d // 512) for d in HUB_DEGREES]
    assert int((graph.local_inv == graph.slot_to_node.shape[0] - 1).sum()) > 5  # isolated + padding nodes


# graphs the plan is checked on: the module's graph, another draw of it, one
# with no hub, and narrow buckets whose 16-wide hub chunks make wide slots
# of many partial rows
PLAN_GRAPHS = {
    "layout": {},
    "layout-seed-3": dict(seed=3),
    "no-hubs": dict(hubs=()),
    "narrow-buckets": dict(hubs=(40, 70), bucket_widths=(1, 2, 4, 8), hub_width=16),
}


@pytest.fixture(scope="module", params=list(PLAN_GRAPHS))
def any_graph(request):
    return _layout_graph(**PLAN_GRAPHS[request.param])[0]


def test_plan_finishes_every_slot_once(any_graph):
    graph, plan = any_graph, pr.build_ell_plan(any_graph)
    items = plan.items.long()
    multi = plan.multi.long()
    single = items[:, 3] < 0
    finished = torch.cat([items[single, 0], multi[:, 0]])
    assert sorted(finished.tolist()) == list(range(plan.n_slots))
    assert int(items[:, 2].max()) <= pr._ELL_SEGMENT
    assert torch.all(items[:-1, 2] >= items[1:, 2]), "items are not sorted heaviest first"
    # entries: each exactly once, item by item in order
    covered = torch.zeros(plan.ent.shape[0], dtype=torch.long)
    for beg, n in items[:, 1:3].tolist():
        covered[beg:beg + n] += 1
    assert torch.all(covered == 1)
    # a wide slot's partial rows: consecutive, owned by its items in entry order
    parts = items[~single]
    by_part = parts[torch.argsort(parts[:, 3])]
    assert by_part[:, 3].tolist() == list(range(plan.n_parts))
    for slot, first, count, _ in multi.tolist():
        rows = by_part[first:first + count]
        assert torch.all(rows[:, 0] == slot) and count > 1
        assert torch.all(rows[1:, 1] > rows[:-1, 1])
    # the entries are the graph's nonzero weights, nothing else
    w = plan.ent[:, 1].contiguous().view(torch.float32)
    nonzero = sum(int((x != 0).sum()) for x in (*graph.bucket_wgt, graph.hub_wgt))
    assert torch.all(w != 0) and w.numel() == nonzero


def _plan_y(plan, p, gather_dtype):
    """T p over the plan, in the kernel's schedule: each item sums its
    entries in entry order (products in float32 from the gather dtype, as
    ``_bucket_reduce`` forms them), and a wide slot its partial rows in
    item order."""
    ld = p.shape[1]
    idx = plan.ent[:, 0].long()
    w = plan.ent[:, 1].contiguous().view(torch.float32)
    src = p
    if gather_dtype == torch.bfloat16:
        w, src = w.to(torch.bfloat16).float(), p.to(torch.bfloat16).float()
    items = plan.items.long()
    y = torch.zeros(plan.n_slots, ld)
    partials = torch.zeros(plan.n_parts, ld)
    for slot, beg, n, part in items.tolist():
        acc = torch.zeros(ld)
        for e in range(beg, beg + n):
            acc = acc + src[idx[e]] * w[e]
        if part < 0:
            y[slot] = acc
        else:
            partials[part] = acc
    for slot, first, n, _ in plan.multi.tolist():
        acc = torch.zeros(ld)
        for j in range(first, first + n):
            acc = acc + partials[j]
        y[slot] = acc
    return y


@pytest.mark.parametrize("gather_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 5, 128])
def test_step_reference_matches_torch_step(graph, plan, b, gather_dtype):
    """The step over the plan, in the kernel's schedule, against the torch
    step of ``batched_ppr_ell``."""
    ld = -(-b // 4) * 4
    r, rdm = _slot_state(graph, _resets(graph, b, seed=b), ld)
    c = torch.ones(b)
    p = r
    for _ in range(2):  # a state two steps in
        p_b, c = _torch_step(graph, p, r, c, rdm, b, None)
        p = torch.nn.functional.pad(p_b, (0, ld - b)).contiguous()
    d = torch.tensor(DAMPING, dtype=torch.float32)
    dm = c[None, :] * rdm[None, :]
    p_next = (1.0 - d) * r[:, :b] + d * (_plan_y(plan, p, gather_dtype)[:, :b] + dm * r[:, :b])

    want_p, _ = _torch_step(graph, p, r, c, rdm, b, gather_dtype)
    # both sum a slot's n non-negative terms in float32, each within
    # (n - 1) u of the exact sum y; d y enters p_next, and the affine update
    # adds a few roundings of p_next's size
    y, n = _exact_y(graph, p, b, gather_dtype)
    bound = DAMPING * 2 * (n[:, None] - 1).clamp_min(0) * U * y + 4 * U * want_p.abs().double()
    assert torch.all((p_next - want_p).abs().double() <= bound)


@pytest.mark.parametrize("accel", ["power", "chebyshev"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cpu_solve_takes_the_torch_step(monkeypatch, graph, accel, compute_dtype):
    """A CPU solve runs ``_spmv_ell``: no plan, no launch, and the span counts
    no kernel iteration."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU solve reached the kernel's plan")

    monkeypatch.setattr(pr, "build_ell_plan", refuse)
    monkeypatch.setattr(pr, "ell_plan", refuse)
    spmv, calls = pr._spmv_ell, []

    def counted(*args, **kwargs):
        calls.append(1)
        return spmv(*args, **kwargs)

    monkeypatch.setattr(pr, "_spmv_ell", counted)
    launches = pr.ELL_STEP_LAUNCHES.count
    with recording(), span("retrieve/ppr") as counted_span:
        _, iters = pr.batched_ppr_ell(graph, _resets(graph, 5, seed=11), damping=DAMPING, max_iters=64,
                                      tol=1e-6, compute_dtype=compute_dtype, accel=accel, return_iters=True)
    assert pr.ELL_STEP_LAUNCHES.count == launches
    assert len(calls) == int(iters[0]) > 0
    assert counted_span.attrs["kernel_iterations"] == 0
    assert counted_span.attrs["iterations"] == int(iters[0])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 5, 8, 128])
def test_kernel_step_pads_columns_and_carries_the_gathered_copy(monkeypatch, graph, plan, b, bf16):
    """``_KernelStep`` launches once per step on a zero-padded [S, ld] state,
    ld the next multiple of 4; with bfloat16 gathers each step reads the copy
    the previous launch wrote (the reset's own copy for r), and converts any
    other state."""
    calls = []

    def launch(plan_, pg, p, r, c, rdm, damping, p_next, pg_next, c_next, partials, resid):
        calls.append(dict(pg=pg, p=p, r=r, c=c, rdm=rdm, pg_next=pg_next, partials=partials))
        p_next.copy_(p + 1.0)
        c_next.copy_(c * 0.5)
        resid.fill_(float(len(calls)))
        if pg_next is not None:
            pg_next.copy_(p_next)

    monkeypatch.setattr(pr, "ell_step", launch)
    ld = -(-b // 4) * 4
    r_slot, rdm = _slot_state(graph, _resets(graph, b, seed=b), b)
    step = pr._KernelStep(plan, r_slot[:, :b].contiguous(), rdm, DAMPING,
                          torch.bfloat16 if bf16 else None)
    s = graph.slot_to_node.shape[0]
    assert tuple(step.r.shape) == (s, ld)
    assert torch.equal(step.r[:, :b], r_slot[:, :b]) and torch.all(step.r[:, b:] == 0)
    assert tuple(step.partials.shape) == (plan.n_parts, ld)

    p, c = step.r, torch.ones(b)
    for k in range(3):
        p_next, c_next = step(p, c)
        assert len(calls) == k + 1 and float(step.resid[0]) == k + 1
        call = calls[-1]
        assert call["p"] is p and call["r"] is step.r and tuple(call["rdm"].shape) == (b,)
        if not bf16:
            assert call["pg"] is p and call["pg_next"] is None
        else:
            assert call["pg"].dtype == torch.bfloat16 and torch.equal(call["pg"], p.to(torch.bfloat16))
            if k:  # the copy the previous launch wrote
                assert call["pg"] is calls[-2]["pg_next"]
        assert torch.equal(p_next, p + 1.0) and torch.equal(c_next, c * 0.5)
        p, c = p_next, c_next
    if bf16:  # a state the step did not write is converted
        fresh = step.r + 2.0
        step(fresh, c)
        assert torch.equal(calls[-1]["pg"], fresh.to(torch.bfloat16))


def test_plan_is_cached_while_the_graph_lives():
    graph, _ = _layout_graph(seed=3)
    plan = pr.ell_plan(graph)
    assert pr.ell_plan(graph) is plan
    assert pr.ell_plan(graph.to("cpu")) is plan  # the same tensors
    key = tuple(id(t) for t in pr._graph_tensors(graph))
    assert key in pr._plans
    del graph  # the last reference: its tensors are freed here
    assert key not in pr._plans


# ---------------------------------------------------------------------------
# the wrapper's argument checks: refused before any launch
# ---------------------------------------------------------------------------
S, PARTS = 640, 3


def _meta_plan(n_slots=S, dtype=torch.int32):
    return pr.ELLStepPlan(ent=torch.empty(100, 2, dtype=dtype, device="meta"),
                          items=torch.empty(50, 4, dtype=dtype, device="meta"),
                          multi=torch.empty(1, 4, dtype=dtype, device="meta"),
                          n_parts=PARTS, n_slots=n_slots)


def _meta_args(b=5, ld=8, state=torch.float32, gather=torch.float32, small=torch.float32):
    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    pg = t(S, ld, dtype=gather)
    return dict(pg=pg, p=t(S, ld, dtype=state), r=t(S, ld), c=t(b, dtype=small), rdm=t(b),
                p_next=t(S, ld), pg_next=t(S, ld, dtype=gather) if gather == torch.bfloat16 else None,
                c_next=t(b), partials=t(PARTS, ld), resid=t(1))


@pytest.mark.parametrize("b,ld,gather", [(5, 8, torch.float32), (128, 128, torch.float32),
                                         (104, 104, torch.bfloat16), (1, 4, torch.bfloat16)])
def test_step_arg_checks_accept(b, ld, gather):
    pr.check_step_args(_meta_plan(), **_meta_args(b, ld, gather=gather))


@pytest.mark.parametrize("change", [
    dict(state=torch.float64), dict(gather=torch.float16), dict(small=torch.bfloat16),
    dict(pg_next=torch.empty(S, 8, dtype=torch.bfloat16, device="meta")),
    dict(plan_dtype=torch.int64),
], ids=["state-f64", "gather-f16", "c-bf16", "pg_next-with-f32", "plan-int64"])
def test_step_arg_checks_refuse_other_dtypes(change):
    change = dict(change)
    plan = _meta_plan(dtype=change.pop("plan_dtype", torch.int32))
    pg_next = change.pop("pg_next", None)
    args = _meta_args(**change)
    if pg_next is not None:
        args["pg_next"] = pg_next
    with pytest.raises(TypeError):
        pr.check_step_args(plan, **args)


@pytest.mark.parametrize("case", ["ld-not-x4", "ld-over-128", "b-over-ld", "slots", "rdm", "partials", "r"])
def test_step_arg_checks_refuse_shapes(case):
    plan = _meta_plan(n_slots=S + 1 if case == "slots" else S)
    b, ld = {"ld-not-x4": (5, 6), "ld-over-128": (130, 132), "b-over-ld": (9, 8)}.get(case, (5, 8))
    args = _meta_args(b, ld)
    if case == "rdm":
        args["rdm"] = torch.empty(b + 1, device="meta")
    if case == "partials":
        args["partials"] = torch.empty(PARTS + 1, ld, device="meta")
    if case == "r":
        args["r"] = torch.empty(S, ld + 4, device="meta")
    with pytest.raises(ValueError):
        pr.check_step_args(plan, **args)


def test_step_arg_checks_refuse_non_contiguous():
    args = _meta_args()
    args["p"] = torch.empty(8, S, device="meta").T
    with pytest.raises(ValueError, match="contiguous"):
        pr.check_step_args(_meta_plan(), **args)


@pytest.mark.parametrize("where", ["cpu", "cpu-and-meta"])
def test_step_refuses_operands_on_two_devices(graph, plan, where):
    r, rdm = _slot_state(graph, _resets(graph, 4, seed=1), 4)
    c = torch.ones(4)
    if where == "cpu-and-meta":
        rdm = rdm.to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        pr.ell_step(plan, r, r, r, c, rdm, DAMPING, torch.empty_like(r), None,
                    torch.empty_like(c), torch.empty(plan.n_parts, 4), torch.empty(1))
