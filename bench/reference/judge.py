"""The comparison that decides a served model's ``correct``: for each
sampled request, the configuration's reference reads the prompt and the
served tokens, and each served token's logit is measured against the
reference's best at its position.  The number compared is the widest
such gap over the sample, in logits (the reference's units).

``reference`` is the configuration's reference module
(``bench.spec.load_reference``), whose ``logits`` runs with
:func:`decoder.fp32` to judge.  With ``control`` the tokens judged are
not the served ones but those that the same reference computed in fp8
(:func:`decoder.fp8`) puts first at the same positions of the same
sequences: the control that a lower precision than the configuration's
bf16 has to fail.
"""

from __future__ import annotations

import torch

from .decoder import fp8, fp32

__all__ = ["gaps", "gap_stats"]


def gaps(reference, params: dict, cfg: dict, prompt, served,
         control=False) -> torch.Tensor:
    """Per served position: the reference's best logit minus its logit
    of the token judged there (the served one, or the control's)."""
    seq = list(prompt) + list(served)[:-1]
    start = len(prompt) - 1
    ref = reference.logits(params, cfg, seq, start, fp32)
    if control:
        chosen = reference.logits(params, cfg, seq, start, fp8).argmax(-1)
    else:
        chosen = torch.as_tensor(list(served), dtype=torch.long, device=ref.device)
    return ref.max(-1).values - ref.gather(1, chosen[:, None])[:, 0]


def gap_stats(reference, params: dict, cfg: dict, samples,
              control: bool = False) -> dict:
    """``samples``: (prompt, served tokens) pairs.  Returns the widest
    gap, the tokens judged, how many of them were not the reference's
    first choice, and the gaps' 50th, 90th and 99th percentiles."""
    g = torch.cat([gaps(reference, params, cfg, p, s, control).float().cpu()
                   for p, s in samples])
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99])).tolist()
    return {"widest": float(g.max()), "tokens": g.numel(),
            "not_first": int((g > 0).sum()), "p50": q[0], "p90": q[1], "p99": q[2]}
