"""GP-ROM refit traffic: a parameter→field GP reduced-order model fitted
to one campaign of simulations after another, through the class flow of
OpenMEASURE's README (``GPR.fit`` → ``train(max_iter, rel_error, lr)`` →
``predict`` at the held-out operating points → ``reconstruct``), one
closed-loop client.

Set-up: ``campaigns`` independent campaigns are made on the card, campaign
k from the seed ``seed · campaigns + k``: each the configuration's
``m_train`` training snapshots at as many operating points and its
``m_test`` held-out ones (``traffic/gp_train.py``'s set-up, which also
warms every shape with a flow cut to 8 Adam iterations).  Call i runs the
whole flow on campaign i mod ``campaigns``, so a window averages trainings
whose early stops differ by campaign.

The comparison is ``gp_train``'s (the float64 reference follows the
program's trained model), on the campaign of the kept call.  The per-layer
counters are ``gp_train``'s, and those of one more flow on the traced
call's campaign, recorded by the program's recorder
(``openmeasure_torch.utils.logging.recording``) after the traced windows:
its ``host_reads`` and its Adam iterations (``gp.iter`` spans).  A program
without those spans gives no iterations there, and the reader that needs
them reports nothing.
"""

from __future__ import annotations

import dataclasses

from benchmark.traffic import gp_train as G

SPANS = G.SPANS
CONFIG_KEYS = G.CONFIG_KEYS
MIX_KEYS = G.MIX_KEYS | {"campaigns"}
outputs, reference, compare = G.outputs, G.reference, G.compare


def setup(ctx):
    n = int(ctx.mix["campaigns"])
    return {"campaigns": [
        G.setup(dataclasses.replace(ctx, seed=ctx.seed * n + k))
        for k in range(n)]}


def _campaign(state, i):
    camps = state["campaigns"]
    return camps[i % len(camps)]


def call(ctx, state, i):
    return G.call(ctx, _campaign(state, i), i)


def end_to_end(ctx, w):
    return {"fit_ms": w.seconds / w.calls * 1e3}


def counters(ctx, state, w):
    from openmeasure_torch.utils.logging import recording
    out = G.counters(ctx, state, w)
    i = w.kept[0][0]
    with recording() as rec:
        G.call(ctx, _campaign(state, i), i)
    out["host_reads"] = rec.counters.get("host_reads", 0)
    out["gp_iters"] = sum(s.name == "gp.iter" for s in rec.spans)
    return out


def evidence(ctx, state, kept):
    return G.evidence(ctx, _campaign(state, kept[0][0]), kept)
