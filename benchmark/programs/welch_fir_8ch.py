"""The system under test for ``welch_fir_8ch``: one call of
``pyfft_tpu_torch.welch_filtered_cross_spectra`` on the record as the
traffic places it (tensors on the card or NumPy arrays on the host), with
the spectra back as NumPy arrays."""
from __future__ import annotations

import dataclasses


def prepare(cfg, inputs, device) -> dict:
    """What a user sets up once: the FIR, the window and the segment plan."""
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import segmentation as seg
    return dict(pt=pt, taps=inputs.taps(cfg), win=inputs.window(cfg),
                plan=seg.plan_segments(cfg["nt"], nwins=cfg["nwins"],
                                       windowoverlap=cfg["overlap"]),
                fs=cfg["fs"], device=device)


def call(state, record) -> dict:
    out = state["pt"].welch_filtered_cross_spectra(
        record["x"], record["y"], state["taps"], state["win"], state["plan"],
        state["fs"], detrend_style=1, device=state["device"])
    return {"Pxx": out["Pxx"], "Pyy": out["Pyy"], "Pxy": out["Pxy"]}


def half_batch(state) -> dict:
    """The state of a program that averages only the first half of the
    segments (a planted fault for the output check's tests)."""
    plan = state["plan"]
    return dict(state, plan=dataclasses.replace(plan, navr=plan.navr // 2))
