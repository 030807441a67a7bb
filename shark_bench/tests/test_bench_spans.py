"""The readers of the program's spans (`metrics/_spans.py`) on synthetic
traces, the accepted readers unmoved by the spans, and the spans in a
trace captured around a training step on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import BENCH, smoke_cell
from shark_bench import bench, trace
from shark_bench.metrics import _spans
from shark_bench.spec import load_spec

MAMBA = load_spec(BENCH / "configs/mamba2-370m.json")
K = "void ssd_fwd_tc<64, 128>(...)"

# Two steps of a training step's spans (microseconds).  Kernel a is
# launched in the forward and runs while the host is in the backward;
# the device idles 2.5-5 inside the forward, 30-35 inside the backward
# and 50-65 from the optimizer on, of which 50-60 lies inside it.  The
# benchmark's own copy at 1.8 and sync at 70 lie outside the program's
# spans.
HOST = [("shark_bench.batch", 0, 2), ("repro_torch.data.batch", 0, 1.5),
        ("cudaMemcpyAsync", 1.8, 1.9),
        ("shark_bench.step", 2, 80),
        ("repro_torch.train.forward", 2, 10),
        ("cudaLaunchKernel", 3, 3.5), ("cudaLaunchKernelExC", 4, 4.5),
        ("cudaMemcpyAsync", 5, 5.5),
        ("repro_torch.train.backward", 10, 40),
        ("cudaLaunchKernel", 11, 11.5), ("cuLaunchKernel", 12, 12.5),
        ("cudaStreamSynchronize", 13, 30),
        ("repro_torch.train.optimizer", 40, 60),
        ("aten::mul", 40.5, 45), ("cudaLaunchKernel", 41, 41.5),
        ("cudaStreamSynchronize", 45, 46),
        ("cudaStreamSynchronize", 70, 71)]
DEV = [("Memcpy HtoD (Pinned -> Device)", 2.0, 2.5),
       ("a", 5, 15), ("b", 15, 20), ("Memcpy HtoD (Device -> Device)", 20, 21),
       (K, 21, 30), ("c", 35, 50), ("d", 65, 70)]


def _record(kind="train", device=DEV, host=HOST, steps=2):
    rec = bench.Record(MAMBA, kind, 1.0, [(16, 2048)] * steps)
    rec.trace = trace.Trace(list(device), list(host))
    rec.traced_work = [(16, 2048)] * steps
    return rec


def read(name, rec):
    return bench.read_metric(name, rec)


def test_device_time_is_credited_by_launch():
    rec = _record()
    # a (10 us) ran in the backward's time, launched in the forward's
    assert read("forward_ms.train", rec) == pytest.approx((10 + 5 + 1) / 2e3)
    assert read("backward_ms.train", rec) == pytest.approx((9 + 15) / 2e3)
    assert read("optimizer_ms.train", rec) == pytest.approx(5 / 2e3)
    assert read("pipeline_ms.train", rec) == pytest.approx(1.5 / 2e3)
    # the sync at 13 and at 45; not the benchmark's at 70
    assert read("host_syncs.train", rec) == 1.0
    # the per-step divisor
    assert read("optimizer_ms.train", _record(steps=1)) == pytest.approx(
        5 / 1e3)


def test_idle_is_cut_to_the_span():
    rec = _record()
    assert _spans.idle_ms(rec, "train", "train.backward") == pytest.approx(
        5 / 2e3)
    assert _spans.idle_ms(rec, "train", "train.optimizer") == pytest.approx(
        10 / 2e3)
    # 2.5-5, before the forward's first kernel ran
    assert _spans.idle_ms(rec, "train", "train.forward") == pytest.approx(
        2.5 / 2e3)
    assert _spans.idle_ms(rec, "train", "data.batch") == 0.0


def test_prefill_readers():
    host = [("shark_bench.generate", 0, 100),
            ("repro_torch.serve.prefill", 0, 20),
            ("cudaMemcpyAsync", 1, 2), ("cudaLaunchKernel", 3, 4),
            ("cudaStreamSynchronize", 4, 5),
            ("repro_torch.serve.decode", 20, 60),
            ("cudaLaunchKernel", 50, 51),
            ("repro_torch.serve.to_host", 60, 70),
            ("cudaMemcpyAsync", 61, 62), ("cudaStreamSynchronize", 62, 63)]
    dev = [("Memcpy HtoD (Pageable -> Device)", 2, 3), (K, 5, 30),
           ("argmax", 52, 54), ("Memcpy DtoH (Device -> Pageable)", 62, 63)]
    rec = _record("prefill", dev, host, steps=1)
    assert read("decode_ms.prefill", rec) == pytest.approx(2 / 1e3)
    # idle 30-52 and 54-60 while the host was in the decode step
    assert read("decode_idle_ms.prefill", rec) == pytest.approx(28 / 1e3)
    assert read("host_syncs.prefill", rec) == 2.0
    assert read("forward_ms.train", rec) is None


def _long(n=200):
    """n kernels of 1 us launched in each of the three spans of one step;
    the device starts each 2 us after the host launched it."""
    host, dev = [], []
    for j, span in enumerate(("forward", "backward", "optimizer")):
        t0 = 1000.0 * j
        host.append((f"repro_torch.train.{span}", t0, t0 + 999))
        for k in range(n):
            host.append(("cudaLaunchKernel", t0 + 4 * k, t0 + 4 * k + 1))
            dev.append((span, t0 + 4 * k + 2, t0 + 4 * k + 3))
    return host, dev


def test_a_lost_record_moves_one_operation_a_boundary():
    host, dev = _long()
    exact = [read(f"{x}_ms.train", _record(device=dev, host=host, steps=1))
             for x in ("forward", "backward", "optimizer")]
    assert exact == pytest.approx([0.2, 0.2, 0.2])
    # a device record lost in the forward: one kernel of the backward is
    # credited to the forward, one of the optimizer to the backward
    lost = dev[:10] + dev[11:]
    got = [read(f"{x}_ms.train", _record(device=lost, host=host, steps=1))
           for x in ("forward", "backward", "optimizer")]
    assert got == pytest.approx([0.2, 0.2, 0.199])
    # a launch record lost there instead: the shift runs the other way,
    # and the last operation takes the last launch
    got = [read(f"{x}_ms.train",
                _record(device=dev, host=host[:12] + host[13:], steps=1))
           for x in ("forward", "backward", "optimizer")]
    assert got == pytest.approx([0.199, 0.2, 0.201])
    # more than LOST of the records: the launches cannot be told
    assert _spans.launch_times(
        _record(device=dev[:590], host=host, steps=1).trace) is None


def test_a_launch_may_read_after_its_operation():
    # the host's clock reads d's launch (41) after d's start
    rec = _record(device=DEV[:-1] + [("d", 40.8, 45)])
    assert _spans.launch_times(rec.trace)[-1] == 41
    assert read("optimizer_ms.train", rec) == pytest.approx(4.2 / 2e3)


def test_nothing_where_nothing_was_seen():
    # the parent program: no spans
    bare = [op for op in HOST if not op[0].startswith("repro_torch.")]
    rec = _record(host=bare)
    for name in ("forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "pipeline_ms.train",
                 "host_syncs.train"):
        assert read(name, rec) is None
    # more device operations than launches: no launch times, no credit
    rec = _record(device=DEV + [("e", 90, 95)])
    assert _spans.launch_times(rec.trace) is None
    assert read("forward_ms.train", rec) is None
    assert read("pipeline_ms.train", rec) is not None
    # a CPU trace: spans but no device operation
    rec = _record(device=[])
    for name in ("forward_ms.train", "pipeline_ms.train", "host_syncs.train"):
        assert read(name, rec) is None
    # another kind, and no trace
    for name in ("decode_ms.prefill", "decode_idle_ms.prefill",
                 "host_syncs.prefill"):
        assert read(name, _record()) is None
    assert read("forward_ms.train",
                bench.Record(MAMBA, "train", 1.0, [(16, 2048)])) is None


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_accepted_readers_read_the_same_with_the_spans(kind):
    bare = [op for op in HOST if not op[0].startswith("repro_torch.")]
    with_spans, without = _record(kind), _record(kind, host=bare)
    for name in (f"device_idle_share.{kind}", f"ssd_roofline.{kind}",
                 f"mfu.{kind}"):
        assert read(name, with_spans) == read(name, without)
    a, b = with_spans.trace.breakdown(), without.trace.breakdown()
    assert a["device_ops"] == b["device_ops"]
    assert [g[1] for g in a["idle_gaps"]] == [g[1] for g in b["idle_gaps"]]
    # a gap with no host operation open is named by the program's phase
    assert "shark_bench.step: repro_torch.train.backward" in [
        g[0] for g in a["idle_gaps"]]


class _Event:
    def __init__(self, name, device, s, e, annotation=False):
        self._n, self._d, self._s, self._e = name, device, s, e
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return type("T", (), {"name": self._d})

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def test_capture_keeps_device_annotations_out(monkeypatch):
    """A `record_function` range shows on the device's timeline too, as a
    user annotation: the device's work stays what it was."""
    events = [_Event("repro_torch.train.forward", "CPU", 0, 9000, True),
              _Event("repro_torch.train.forward", "CUDA", 1000, 9000, True),
              _Event("shark_bench.step", "CUDA", 0, 9000, True),
              _Event("cudaLaunchKernel", "CPU", 500, 600),
              _Event(K, "CUDA", 1000, 4000)]

    class Profile:
        def __init__(self, activities):
            self.profiler = type("P", (), {"kineto_results": type(
                "R", (), {"events": staticmethod(lambda: events)})})

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    got = trace.capture(lambda: None, cuda=False)
    assert got.device_ops == [(K, 1.0, 4.0)]
    assert [n for n, _, _ in got.host_ops] == [
        "repro_torch.train.forward", "cudaLaunchKernel"]


def test_capture_holds_the_program_spans(smoke_root):
    """A traced CPU training step of the smoke cell: the program's spans
    are host operations, once a step each."""
    from shark_bench import corpus, port
    cell = smoke_cell(smoke_root, "mamba2-370m.train-16x2k-smoke")
    spec, tr = cell.spec, cell.traffic
    c = tr["corpus"]
    cols = corpus.draw(spec.vocab, c["n_docs"], c["mean_doc_len"], 7)
    sess, pipe = port.pipeline(cols, c["partitions"], "quality > 0.1",
                               tr["seq"], tr["batch"], 7, "cpu")
    cfg = port.model_config(spec)
    model = port.model(spec, 7, torch.device("cpu"), cfg)
    step, opt = port.trainer(cfg, model, tr["optimizer"])

    def one():
        b = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
        step(model, opt, b)
    t = time.perf_counter()
    got = trace.capture(one, cuda=False)
    assert time.perf_counter() - t < 60
    sess.shutdown()
    names = [n for n, _, _ in sorted(got.host_ops, key=lambda o: o[1])
             if n.startswith("repro_torch.")]
    assert names == ["repro_torch.data.batch", "repro_torch.train.forward",
                     "repro_torch.train.backward",
                     "repro_torch.train.optimizer"]
    assert got.device_ops == []
