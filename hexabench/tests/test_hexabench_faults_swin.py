"""The Swin train cell's run, with the harness's look for a card skipped,
at a smoke size on the CPU: sound, it reads correct; with the timed path
broken underneath (a step that returns its state unchanged; half of the
batch left out, the mean over the rest), ``correct`` comes out false; the
half-batch fault put in the program's place (as ``calibrate.py`` reads
it) comes out not correct under the committed limits, and the TF32
control reads far above the program. (At smoke widths TF32's error is
smaller than at the cell's and its change gap falls either side of the
cell's limit from seed to seed; ``calibrate.py`` prints its verdict at
the cell's own size on the card.)"""
import pytest

from hexabench import bench
from hexabench.drivers import train
from hexabench.tests import smoke


def test_swin_sound_run_is_correct():
    out = train.run(smoke.swin_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def _broken_step(monkeypatch, kind):
    from repro_torch.models import swin

    real = swin.make_train_step

    def make(cfg, pcfg, opt_cfg, **kw):
        step = real(cfg, pcfg, opt_cfg, **kw)
        loss_fn = swin.make_loss_fn(cfg, pcfg, moe_impl=kw["moe_impl"])

        def unchanged(params, opt_state, images, labels):
            total, m = loss_fn(params, images, labels)
            return params, opt_state, {**m, "loss": total.detach()}

        def half(params, opt_state, images, labels):
            n = images.shape[0] // 2
            return step(params, opt_state, images[:n], labels[:n])

        return unchanged if kind == "unchanged" else half

    monkeypatch.setattr(swin, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_swin_faults_read_incorrect(monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    out = train.run(smoke.swin_cell())
    assert not out["correct"], out["checks"]


def test_swin_tf32_control_reads_far_above_the_program():
    cell = smoke.swin_cell()
    out = train.run(cell)
    assert out["correct"], out["checks"]
    control = train.control_numbers(cell, out, "tf32")
    p = {k: v["value"] for k, v in out["checks"].items()}
    assert control["grad_gap"] > 3 * p["grad_gap"]
    fault = train.half_batch_numbers(cell, out)
    assert bench.judge(fault, cell.limits)[0] is False, fault
