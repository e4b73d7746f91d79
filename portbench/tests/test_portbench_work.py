"""The yardstick's arithmetic against hand counts at tiny shapes: the
kernels' compulsory bytes and operations, the model FLOPs, and the
trace's busy time, gaps and rooflines."""

import pytest
import torch

from portbench.harness import trace, work


def test_gather_bytes_counts_ids_distinct_rows_and_outputs():
    ids = torch.tensor([3, 3, 5, 0], dtype=torch.int32)
    # 4 ids read, rows 3, 5, 0 read once, 4 rows written, 8 bytes a row
    assert work.gather_bytes(ids, None, 8) == 4 * 4 + 3 * 8 + 4 * 8
    valid = torch.tensor([True, True, False, False])
    # only row 3 is needed, twice written
    assert work.gather_bytes(ids, valid, 8) == 4 * 4 + 1 * 8 + 2 * 8


def test_scatter_bytes_counts_gradients_ids_and_distinct_rows():
    a = torch.tensor([1, 2], dtype=torch.int32)
    b = torch.tensor([[2, 7], [9, 1]], dtype=torch.int32)
    vb = torch.tensor([[True, False], [True, True]])
    # ids: 2 + 4; valid gradient rows: 2 + 3; distinct rows: 1, 2, 9
    assert work.scatter_bytes([(a, None), (b, vb)], 16) == \
        6 * 4 + 5 * 16 + 3 * 16


def test_cand_work_by_hand():
    B, C, T, n, m, d, es, vu, vi = 2, 3, 4, 5, 6, 8, 2, 17, 40
    moved, flops = work.cand_work(B, C, T, n, m, d, es, vu, vi, False)
    out = 2 * B * C * T * d * es
    assert moved == ((vu + vi) * d * es + B * T * n + B * C * T * m
                     + 4 * d * d + (B + B * C) * d * es + out)
    assert flops == (2 * d * d * B * T * (1 + C) + d * vu + 4 * d * C * vu
                     + 5 * d * vi)
    moved_b, flops_b = work.cand_work(B, C, T, n, m, d, es, vu, vi, True)
    assert moved_b == moved + (B * T * n + B * C * T * m) * d * es + \
        (B + B * C) * d * es + 4 * d * d
    assert flops_b == (6 * d * d * B * T * (1 + C) + 11 * d * C * vu
                       + d * vu + 11 * d * vi)


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert work.bound_s(3.35e12) == pytest.approx(1.0)
    assert work.bound_s(1.0, 67e12) == pytest.approx(1.0)


MODEL = dict(arch="score", embed_dim=2, hidden_dim=3, mlp_dims=[4],
             sides="dual", slot_agg="mean", seq_encoder="gru",
             seq_pool="last", target_aware=False, coattn_pool="sum",
             compute_dtype="bfloat16", param_dtype="float32")
DATA = dict(slots=2, user_fanout=2, item_fanout=3)


def test_forward_flops_by_hand_slot_mean_last_state():
    B, C, d, f, T, n, m = 1, 1, 2, 3, 2, 2, 3
    slot_means = B * T * n * d + B * C * T * m * d
    gru = (B + B * C) * T * (2 * d * 3 * f + 2 * f * 3 * f + 12 * f)
    width = 3 * f + 3 * d
    scorer = B * C * (2 * width * 4 + 2 * 4 * 1 + f + d)
    assert work.forward_flops(MODEL, DATA, B, C) == slot_means + gru + scorer
    assert work.train_flops(MODEL, DATA, B, 1) == \
        3 * work.forward_flops(MODEL, DATA, B, 2)


def test_forward_flops_grows_with_the_coattention_and_pooling():
    score = dict(MODEL, slot_agg="coattn", seq_pool="attn",
                 target_aware=True)
    assert work.forward_flops(score, DATA, 4, 5) > \
        work.forward_flops(MODEL, DATA, 4, 5)


@pytest.mark.parametrize("param,compute,training,want", [
    ("float32", "bfloat16", True, (4, 2)),
    ("float32", "bfloat16", False, (2, 2)),
    ("bfloat16", "bfloat16", True, (2, 2)),
    ("float32", "float32", False, (4, 4))])
def test_element_bytes_follow_the_configured_dtypes(param, compute,
                                                    training, want):
    m = dict(MODEL, param_dtype=param, compute_dtype=compute)
    assert work.elem_bytes(m, training) == want


@pytest.mark.parametrize("key,value", [
    ("arch", "sasrec"), ("sides", "single"), ("seq_encoder", "sasrec"),
    ("slot_agg", "max"), ("seq_pool", "mean")])
def test_values_the_reference_does_not_cover_raise(key, value):
    from portbench.harness import weights
    from portbench.reference import model as ref_model
    m = dict(MODEL, **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        work.forward_flops(m, DATA, 1, 1)
    with pytest.raises(NotImplementedError, match=key):
        weights.leaves(m, 3, 4)
    with pytest.raises(NotImplementedError, match=key):
        ref_model.check_supported(m)


def test_a_coattention_pool_other_than_sum_raises():
    from portbench.harness import weights
    m = dict(MODEL, slot_agg="coattn", coattn_pool="max")
    with pytest.raises(NotImplementedError, match="coattn_pool"):
        work.forward_flops(m, DATA, 1, 1)
    with pytest.raises(NotImplementedError, match="coattn_pool"):
        weights.leaves(m, 3, 4)
    # the pool is no part of a model without the co-attention
    work.forward_flops(dict(MODEL, coattn_pool="max"), DATA, 1, 1)


def _trace(kernels, wall=10.0, units=2, **kw):
    return trace.Trace(window_s=wall, kernels=kernels, units=units,
                       spans=kw.get("spans", {}), aligned=True,
                       work=kw.get("work", {}),
                       flops=kw.get("flops", 0.0),
                       own=("gather_rows_kernel", "cand_fwd_kernel"))


def test_busy_union_gaps_and_idle_share():
    t = _trace([("void gather_rows_kernel<int>(int*)", 0.0, 2.0),
                ("ampere_sgemm", 1.0, 2.0),
                ("Memcpy HtoD", 5.0, 1.0)])
    assert t.busy_s() == pytest.approx(4.0)
    assert t.gaps() == [(3.0, 5.0)]
    assert len(t.kernel_list()) == 2
    assert t.is_own("void gather_rows_kernel<int>(int*)")
    assert t.is_own("void (anonymous namespace)::gather_rows_kernel<int>()")
    assert not t.is_own("void at::native::gather_rows_kernel<int>(int*)")


def test_roofline_is_bound_over_kernel_time():
    t = _trace([("void cand_fwd_kernel<float>(float*)", 0.0, 4.0)],
               work={"coattn_fwd": 1.0})
    assert t.roofline("coattn_fwd", ("cand_fwd_kernel",)) == \
        pytest.approx(25.0)
    assert t.roofline("gather", ("gather_rows_kernel",)) is None


def test_own_kernel_names_read_the_program_sources():
    from portbench.run import ROOT
    names = trace.own_kernel_names(ROOT / "score_tpu_torch")
    for k in ("gather_rows_kernel", "gather_flat_kernel",
              "scatter_add_kernel", "cand_fwd_kernel", "coattn_bwd_kernel",
              "sum_partials_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names


def test_breakdown_names_gaps_by_span_and_next_operation():
    t = _trace([("void gather_rows_kernel<int>(int*)", 0.0, 1.0),
                ("ampere_sgemm", 3.0, 1.0)],
               spans={"call": [(0.0, 4.0)]})
    b = t.breakdown()
    assert b["device_ops"][0] == ["gather_rows_kernel<int>", 1.0]
    assert b["idle_gaps"] == [["call, before ampere_sgemm", 2.0]]


def test_per_layer_readers_on_a_small_trace():
    from portbench import run
    t = _trace([("void gather_rows_kernel<int>(int*)", 0.0, 2.0),
                ("ampere_sgemm", 3.0, 1.0)], wall=5.0, units=2,
               spans={"call": [(0.0, 2.5), (2.5, 5.0)],
                      "stage_chunk": [(0.0, 0.5)]},
               work={"gather": 1.0}, flops=989e12)
    assert run.reader("gather_roofline.serve")(t) == pytest.approx(50.0)
    assert run.reader("idle_share.serve")(t) == pytest.approx(0.4)
    assert run.reader("serve_host_ms.serve")(t) == pytest.approx(1e3)
    assert run.reader("host_stage_ms.train")(t) == pytest.approx(250.0)
    assert run.reader("kernels_per_call.serve")(t) == 1.0
    assert run.reader("torch_ops_ms.serve")(t) == pytest.approx(500.0)
    assert run.reader("mfu.serve")(t) == pytest.approx(20.0)
    assert run.reader("scatter_roofline.train")(t) is None
