"""The plain reference agrees with the port on the CPU at small widths in
float32: the logits of a forward pass (no capacity, as serving runs),
and the scoring loss with its capacity drops and load-balance term."""
import dataclasses

import pytest
import torch

from portbench import harness, weights
from portbench.reference import lm as reference
from portbench.tests import small

CONFIGS = ("deepseek-moe-16b", "granite-moe-1b-a400m")


def _small(name, **moe):
    conf = small.small_config(harness.config(name))
    cfg = small.small_model_cfg(conf)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
        conf = dict(conf, **{k: v for k, v in moe.items()
                             if k == "capacity_factor"})
    return conf, cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_logits_agree(name):
    from repro_torch.models import transformer
    torch.manual_seed(0)
    conf, cfg = _small(name)
    w = weights.draw(cfg, 5, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        port, _ = transformer.forward(w, tokens, cfg, spec="dense")
        hid, _ = reference.hidden(w, conf, tokens.tolist())
        ref = reference.logits_at(w, hid, torch.arange(48))
    assert torch.allclose(port.reshape(48, -1), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_scoring_loss_agrees(name, cf):
    from repro_torch.models import api
    conf, cfg = _small(name, capacity_factor=cf, impl="fse_dp")
    w = weights.draw(cfg, 6, "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], dim=1)
    with torch.no_grad():
        port, parts = api.loss_fn(w, {"tokens": tokens, "labels": labels},
                                  cfg, use_flash=True)
        ce, aux = reference.score_terms(w, conf, tokens, labels, cf)
    ref = ce + cfg.moe.aux_loss_coef * aux
    assert abs(float(port) - ref) < 1e-5 * abs(ref)
    assert abs(float(parts["aux"]) - aux) < 1e-5 * abs(aux)
    if cf < 1:
        # at cf 0.5 the capacity drops choices: without the drops the
        # reference must disagree
        free, _ = reference.score_terms(w, conf, tokens, labels, 100.0)
        assert abs(free - ce) > 1e-3


def test_served_gaps_are_zero_on_the_reference_argmax():
    conf, cfg = _small("deepseek-moe-16b")
    w = weights.draw(cfg, 7, "cpu")
    prompt = [3, 9, 27, 81, 243]
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            hid, _ = reference.hidden(w, conf, [seq])
            z = reference.logits_at(w, hid, torch.tensor([len(seq) - 1]))
            seq.append(int(z.argmax()))
        served = seq[len(prompt):]
        (gaps,) = reference.served_gaps(w, conf, [prompt], [served])
        assert float(gaps.max()) == 0.0
        (bad,) = reference.served_gaps(w, conf, [prompt],
                                       [[(t + 1) % cfg.vocab_size
                                         for t in served]])
    assert float(bad.min()) > 0.0
