"""The serve cell's run, with the harness's look for a card skipped, at a
smoke size on the CPU: sound, it reads correct; with a token altered
where it is produced, ``correct`` comes out false; the fp8 control (the
reference in the program's place) comes out not correct under the
committed limits."""
from hexabench import bench
from hexabench.drivers import serve
from hexabench.tests import smoke


def test_serve_sound_run_is_correct(monkeypatch):
    smoke.step_clock(monkeypatch)
    out = serve.run(smoke.lm_cell())
    assert out["correct"], (out["checks"], out["attempted"], out["failed"])
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["token_excess"]["value"] == 0.0


def test_serve_altered_token_reads_incorrect(monkeypatch):
    from repro_torch.launch import serve as port_serve

    real = port_serve.draw_rows

    def altered(rows, reqs, *a, **kw):
        tok, finite = real(rows, reqs, *a, **kw)
        return (tok + 1) % rows.shape[-1], finite

    monkeypatch.setattr(port_serve, "draw_rows", altered)
    smoke.step_clock(monkeypatch)
    out = serve.run(smoke.lm_cell())
    assert not out["correct"], out["checks"]
    assert out["checks"]["token_excess"]["value"] > 0


def test_serve_fp8_control_reads_far_above_the_program(monkeypatch):
    smoke.step_clock(monkeypatch)
    cell = smoke.lm_cell(wide=True)
    out = serve.run(cell)
    assert out["correct"], out["checks"]
    control = serve.control_numbers(cell, out, "fp8")
    assert bench.judge(control, cell.limits)[0] is False, control
    assert control["logit_err"] > 3 * out["checks"]["logit_err"]["value"]
