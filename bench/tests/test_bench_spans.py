"""The program's spans in a profiled slice (``bench/spans.py``): on
hand-built profiler events, a launch inside ``moe.experts``, one inside
``trace.count`` and one in the decode step's own code, and a device-side
annotation range that spans the gaps between their kernels; and on a CPU
run of a reduced configuration with the spans on."""
import math
from types import SimpleNamespace

import pytest

from _small import small_config
from bench import profile, roofline, spans
from repro_torch.obs.spans import PROFILER, SpanRecord


@pytest.fixture(autouse=True)
def _profiler_clean():
    yield
    PROFILER.disable()
    PROFILER.reset()


def ev(name, start, end, id=0, thread=1, activity="cpu_op"):
    """A profiler event as ``FunctionEvent`` shows one, times in us."""
    return SimpleNamespace(
        name=name, id=id, thread=thread, activity_type=activity,
        is_user_annotation=activity in ("user_annotation", "gpu_user_annotation"),
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def span(name, start, end):
    return ev(name, start, end, activity="user_annotation")


HOST = [span("serve.decode", 0, 100), span("model.moe", 10, 60),
        span("moe.experts", 20, 40), span("trace.count", 45, 50),
        ev("aten::mm", 21, 25),
        ev("cudaLaunchKernel", 22, 23, id=1, activity="cuda_runtime"),
        ev("cudaLaunchKernel", 46, 47, id=2, activity="cuda_runtime"),
        # the runtime's own thread id: matched to the spans by time
        ev("cudaLaunchKernel", 70, 71, id=3, thread=9, activity="cuda_runtime")]
DEVICE = [ev("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NN", 30, 50, id=1,
             activity="kernel"),
          ev("void at::native::reduce_kernel<512, 1>(...)", 52, 53, id=2,
             activity="kernel"),
          ev("direct_copy_kernel_cuda", 80, 90, id=3, activity="kernel"),
          ev("serve.decode", 30, 90, id=4, activity="gpu_user_annotation")]


def test_annotation_ranges_are_not_device_operations():
    ops = spans.device_ops(DEVICE)
    assert [e.id for e in ops] == [1, 2, 3]
    assert not set(profile.by_kernel(ops)) & {"serve.decode"}
    assert profile.busy_intervals(ops) == [(30, 50), (52, 53), (80, 90)]
    # kept in, the range would fill the gaps and read the card busy
    assert profile.busy_intervals(DEVICE) == [(30, 90)]


def test_by_span_and_idle_gaps_by_span():
    out = spans.by_span(DEVICE, HOST)
    assert out == {"moe.experts": [pytest.approx(20e-6), 1],
                   "trace.count": [pytest.approx(1e-6), 1],
                   "serve.decode": [pytest.approx(10e-6), 1]}
    busy = profile.busy_intervals(spans.device_ops(DEVICE))
    idle = dict(spans.idle_by_span(busy, HOST))
    # (50, 52) falls in model.moe after trace.count closed; (53, 80) in the
    # decode step's own code
    assert idle == {"model.moe": pytest.approx(2e-6),
                    "serve.decode": pytest.approx(27e-6)}


def test_moe_split_and_decode_launches_leave_the_counters_out():
    assert spans.moe_split(DEVICE, HOST) == {
        "decode": {"moe.experts": pytest.approx(20e-6)}}
    assert spans.decode_launches(HOST) == 2.0


COUNTS = {"d_model": 6144, "d_expert": 16384, "kept": 32, "routed": 8,
          "assigned": 32, "slots": 1024}


def records(counts=COUNTS):
    return [SpanRecord("serve.decode", 0.0, 1.0, 0, 0, None, None, {"rows": 16}),
            SpanRecord("model.moe", 0.1, 0.6, 1, 1, 0, None, dict(counts)),
            SpanRecord("moe.experts", 0.2, 0.4, 2, 2, 1, None, {})]


def test_moe_bound_is_the_larger_of_products_and_weight_bytes():
    per_expert = 3 * 6144 * 16384
    weights = 2 * per_expert * 8 / roofline.HBM_BYTES_PER_S
    assert spans.moe_bound_s(COUNTS) == pytest.approx(weights)
    many = dict(COUNTS, kept=10 ** 6)
    assert spans.moe_bound_s(many) == pytest.approx(
        2 * per_expert * 10 ** 6 / roofline.PEAK_BF16_FLOPS)


def test_moe_roofline_reads_the_decode_layers():
    got = spans.moe_roofline(DEVICE, HOST, records(), "decode")
    assert got == pytest.approx(100 * spans.moe_bound_s(COUNTS) / 20e-6)
    assert spans.moe_roofline(DEVICE, HOST, records(), "prefill") is None
    # a record that lies under another iteration kind than its range
    wrong = [r._replace(name="serve.prefill") if r.sid == 0 else r
             for r in records()]
    assert spans.moe_roofline(DEVICE, HOST, wrong, "decode") is None


def test_queue_wait_p90():
    recs = [SpanRecord("serve.queued", t0, t1, 0, i, None, i, {})
            for i, (t0, t1) in enumerate([(0.0, 9.0), (10.0, 10.1),
                                           (10.0, 10.5), (11.0, 13.0)])]
    # prefills started in [10, 12]: waits of 100 and 500 ms
    assert spans.queue_wait_p90_ms(recs, 10.0, 12.0) == pytest.approx(
        100 + 0.9 * 400)


def test_readings_find_nothing_without_spans():
    host = [e for e in HOST if e.activity_type != "user_annotation"]
    device = [e for e in DEVICE if e.activity_type == "kernel"]
    assert spans.by_span(device, host) == {"host": [pytest.approx(31e-6), 3]}
    assert spans.decode_launches(host) is None
    assert spans.moe_split(device, host) == {}
    assert spans.moe_roofline(device, host, [], "decode") is None
    assert spans.moe_roofline(DEVICE, HOST, [], "decode") is None
    assert spans.queue_wait_p90_ms([], 0.0, 1.0) is None
    busy = profile.busy_intervals(device)
    assert spans.idle_by_span(busy, host) == [["host", pytest.approx(29e-6)]]


def test_cpu_run_records_the_wait_of_every_request_prefilled():
    """The harness's closed loop over a reduced Mixtral stage, the spans on
    from the first submission: each prefill of the window has its
    ``serve.queued``, which starts as the harness submits the request (its
    stamp follows the engine's) and ends as its prefill iteration starts."""
    import torch
    from bench import loop as loop_mod, run, traffic
    from repro_torch.serve.engine import ServingEngine
    torch.manual_seed(0)
    cfg = small_config("mixtral-8x22b-pp4", dtype="float32")
    _, _, _, mix, _ = run.load_cell("mixtral-pp4-paper-c16")
    ref, program = run.family(cfg)
    model, params = program.build(cfg, ref.draw(cfg, 2**31 + 5, "cpu"))
    engine = ServingEngine(model, params, max_slots=mix["slots"],
                           max_len=mix["max_len"], device="cpu")
    PROFILER.enable(reset=True)
    loop = loop_mod.ClosedLoop(engine, traffic.stream(mix, 2**31 + 5, ref.dims(cfg).V),
                               mix["clients"])
    loop.warm_up()
    t_open, t_close = loop.run(1.0)
    PROFILER.disable()
    recs = PROFILER.records()
    queued = {r.rid: r for r in recs if r.name == "serve.queued"}
    prefilled = [r.rid for r in recs if r.name == "serve.prefill"]
    assert prefilled and sorted(queued) == sorted(prefilled)
    starts = [it.t0 for it in loop.iterations if it.kind == "prefill"]
    for rid in prefilled:
        q, s = queued[rid], loop.served[rid]
        assert q.t0 <= s.t_submit and math.isclose(q.t0, s.t_submit, abs_tol=0.01)
        assert q.t1 <= s.t_first
        assert any(math.isclose(q.t1, t, abs_tol=0.01) for t in starts)
    in_window = [q for q in queued.values() if t_open <= q.t1 <= t_close]
    assert len(in_window) == sum(1 for t in starts if t_open <= t <= t_close)
    assert spans.queue_wait_p90_ms(recs, t_open, t_close) is not None
