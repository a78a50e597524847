"""Whether the timed path's output is correct: the frames after the window
against the frozen plain reference (`reference/`), from the same inputs.

Once the window has closed and the memory peak is read, the program
renders `N_CHECK` more frames through the window's own call (a graph
replay), the first with a click in a clicking cell.  Its feedback states
(ReSTIR reservoirs, denoiser history, exposure) before them, its u8
frames and states after each, its world and light tables and its
triangle soup are kept; the program is freed.  Then the reference, an
Engine of `reference/` on the same device (every kernel's plain PyTorch
twin, TF32 off), builds its own world, atlas and character from the
configuration, replays every click (its own picks) and character step of
the run, takes the program's feedback states of the first check frame —
the one thing it takes from the program: it cannot follow some hundred
frames of history in the time of a run — and renders the check frames
from the logged poses and dt.  The numbers compared:

- frame_off3: the share of u8 values more than 3 levels from the
  reference's, the worse of the check frames;
- frame_mean_abs: the mean u8 difference, the worse check frame;
- state_far: the share of feedback-state values (the reservoirs' packed
  halves unpacked) not within 1e-3 relative (+1e-5) of the reference's,
  the worse check frame;
- picks_diff, tables_diff (clicking cells): picks that differ, and table
  entries that differ after the check frames;
- soup_max_abs (a character in the scene): the largest difference of
  the soup's rows.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from . import session as S

N_CHECK = 2
REL, ABS = 1e-3, 1e-5


# --------------------------------------------------------------------------
# the program's side
# --------------------------------------------------------------------------

def program_side(sess, free: bool = True) -> dict:
    """The check frames on the program, after the window; frees the
    program's engine (unless not `free`: the calibration goes on)."""
    eng = sess.eng
    sess.phase = "check"
    out = dict(state0=S.feedback_state(eng), frames=[])
    for k in range(N_CHECK):
        force = 1 if (k == 0 and sess.traffic.clicks is not None) else 0
        u8 = sess.frame(sess.clock() - sess.t0, force_clicks=force)
        out["frames"].append(dict(rec=sess.frames[-1], u8=u8.clone(),
                                  state=S.feedback_state(eng)))
    out["tables"] = S.tables(eng)
    out["soup"] = S.soup_rows(eng)
    for f in out["frames"]:
        f["state"] = {k: v.cpu() for k, v in f["state"].items()}
        f["u8"] = f["u8"].cpu()
    if not free:
        return out
    eng.release_graphs()
    sess.eng = None
    del eng
    gc.collect()
    if sess.device != "cpu":
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------

def _round_bf16(x):
    """Every float32 tensor in x (tensors, tuples, named tuples) rounded
    to bfloat16 and back."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        return x
    if isinstance(x, tuple):
        vals = [_round_bf16(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


@contextlib.contextmanager
def control(kind):
    """The reference in a lower precision.  "bf16": every float32 plane
    that crosses a stage of the frame stored in bfloat16 (the G-buffers,
    the denoiser's output and history, post's linear output and
    exposure); "tf32": products and convolutions in TF32; None: as it
    is."""
    from reference.render import pathtracer, postprocess, renderer
    saved = (pathtracer.render_frame, renderer.denoise_frame,
             postprocess.run, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if kind == "bf16":
        rf, dn, pp = saved[:3]

        def render_frame(*a, **k):
            g, restir = rf(*a, **k)
            return _round_bf16(g), restir

        def denoise_frame(*a, **k):
            return _round_bf16(dn(*a, **k))

        def run(*a, **k):
            return _round_bf16(pp(*a, **k))
        pathtracer.render_frame = render_frame
        renderer.denoise_frame = denoise_frame
        postprocess.run = run
    elif kind not in (None, "tf32"):
        raise ValueError(f"no control {kind!r}")
    try:
        yield
    finally:
        (pathtracer.render_frame, renderer.denoise_frame, postprocess.run,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _aim(ref, pose, keep_history: bool):
    if pose is not None:
        pos, yaw, pitch = pose
        ref.set_camera(pos=pos, yaw=yaw, pitch=pitch,
                       keep_history=keep_history)


def reference_side(sess, prog: dict, kind=None, fresh=False) -> dict:
    """The reference's check frames from the program's first state, after
    replaying the run's clicks and character steps on its own engine.
    fresh: from the reference's own first state instead, rendering every
    frame of the run before the check frames too (set-up, window): the
    states the program handed over, worked out again."""
    from reference.assets import blocks as RB
    from reference.core.config import Settings
    from reference.core.scene import SceneConfig
    from reference.render.renderer import Engine
    with control(kind):
        ref = Engine(settings=S.settings_of(Settings, sess.cfg,
                                            sess.window_size),
                     scene=SceneConfig(**sess.cfg.get("scene", {})),
                     device=sess.device)
        if kind == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        tr = sess.traffic
        steps = iter(sess.char_log)
        done_steps = 0
        ch = None
        if tr.character is not None:
            from reference.models.character import Character
            ch = Character(cfg_world=ref.cfg,
                           move=ref.settings.character_movement)
            ch.position = tr.character_start(ref.host_world.blocks)
            dt, _ = next(steps)
            ch.update(ref.host_world, dt)
            done_steps = 1
            ref.add_entity(ch.entity)

        def step_to(n: int):
            nonlocal done_steps
            while done_steps < n:
                dt, move = next(steps)
                ch.update(ref.host_world, dt, move, False, False, False)
                done_steps += 1

        placed = [None]
        picks_diff = 0

        def click(c):
            nonlocal picks_diff
            _aim(ref, c["pose"], keep_history=True)
            hit, xyz, n = ref.pick_block()
            pick = (bool(hit), tuple(int(v) for v in xyz),
                    tuple(float(v) for v in n))
            picks_diff += pick != c["pick"]
            if c["action"] == "place" and hit:
                target = tuple(int(xyz[i] + n[i]) for i in range(3))
                ref.set_block(*target, int(getattr(RB,
                                                   tr.clicks["block"])))
                placed[0] = target
            elif c["action"] == "delete_placed" and hit and \
                    placed[0] is not None:
                ref.delete_block(*placed[0])
                placed[0] = None

        first = prog["frames"][0]["rec"]["n"]
        clicks = sorted(sess.clicks, key=lambda c: c["k"])
        before = sess.frames[:first] if fresh else []
        if not fresh:
            for c in clicks:
                if c["frame"] < first:
                    click(c)
            if ch is not None:
                step_to(prog["frames"][0]["rec"]["char_steps"])
        out = dict(frames=[])
        checked = [pf["rec"] for pf in prog["frames"]]
        for rec in before + checked:
            if ch is not None:
                step_to(rec["char_upto"])
            _aim(ref, rec["hist"], keep_history=False)
            _aim(ref, rec["pose"], keep_history=False)
            for c in clicks:
                if c["frame"] == rec["n"]:
                    click(c)
            # a click made before the frame's camera moved aimed from the
            # pose before
            _aim(ref, rec["pose"], keep_history=True)
            ref.frame_index = rec["n"]
            if rec is checked[0] and not fresh:
                ref._ensure_states()
                _load_state(ref, prog["state0"])
            u8 = ref._eager_frame(rec["dt"])
            if rec["n"] >= first:
                out["frames"].append(dict(
                    u8=u8.cpu(),
                    state={n: v.cpu() for n, v in
                           S.feedback_state(ref).items()}))
        out["tables"] = S.tables(ref)
        out["soup"] = S.soup_rows(ref)
        out["picks_diff"] = picks_diff
    del ref
    gc.collect()
    if sess.device != "cpu":
        torch.cuda.empty_cache()
    return out


def _load_state(ref, state: dict):
    if "restir" in state:
        ref.restir_state.data.copy_(state["restir"])
    ds = ref.denoiser_state
    for name in type(ds)._fields:
        getattr(ds, name).copy_(state["denoise." + name])
    ref.post_state.exposure.copy_(state["post.exposure"])


# --------------------------------------------------------------------------
# the numbers compared
# --------------------------------------------------------------------------

def _unpack_restir(data: torch.Tensor) -> list:
    """The reservoir planes as values: plane 0 (kind | slot) as ints,
    planes 3 and 5 as floats, the bf16 pairs of the others as two float
    planes each."""
    bits = data.contiguous().view(torch.int32)
    out = [bits[0].to(torch.float64)]
    for i in range(1, data.shape[0]):
        if i in (3, 5):
            out.append(data[i])
        else:
            out.append((bits[i] << 16).view(torch.float32))
            out.append((bits[i] & -65536).view(torch.float32))
    return out


def _far(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(values not close, values) of a against the reference b."""
    a = a.double()
    b = b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    same_inf = torch.isinf(a) & (a == b)
    close = (a - b).abs() <= REL * b.abs() + ABS
    ok = close | both_nan | same_inf
    return int((~ok).sum()), a.numel()


def state_far(p: dict, r: dict) -> float:
    far = total = 0
    for name, pv in p.items():
        rv = r[name]
        if name == "restir":
            pairs = zip(_unpack_restir(pv), _unpack_restir(rv))
        elif pv.dtype == torch.bool:
            pairs = [(pv.double(), rv.double())]
        else:
            pairs = [(pv, rv)]
        for a, b in pairs:
            f, n = _far(a, b)
            far += f
            total += n
    return far / max(total, 1)


def compare(prog: dict, ref: dict, clicking: bool, character: bool) -> dict:
    """{number: value} of the program's check against the reference's."""
    off3 = mean_abs = far = 0.0
    for pf, rf in zip(prog["frames"], ref["frames"]):
        d = (pf["u8"].to(torch.int16) - rf["u8"].to(torch.int16)).abs()
        off3 = max(off3, float((d > 3).double().mean()))
        mean_abs = max(mean_abs, float(d.double().mean()))
        far = max(far, state_far(pf["state"], rf["state"]))
    out = dict(frame_off3=off3, frame_mean_abs=mean_abs, state_far=far)
    if clicking:
        out["picks_diff"] = float(ref["picks_diff"])
        out["tables_diff"] = float(sum(
            int((prog["tables"][k] != v).sum())
            if prog["tables"][k].shape == v.shape else v.size
            for k, v in ref["tables"].items()))
    if character:
        worst = 0.0
        for k, v in ref["soup"].items():
            a = torch.as_tensor(prog["soup"][k]).double()
            b = torch.as_tensor(v).double()
            if a.shape != b.shape:
                worst = float("inf")
                break
            if a.numel():
                worst = max(worst, float((a - b).abs().max()))
        out["soup_max_abs"] = worst
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): correct when every number is at
    or under its limit (a number without a limit fails)."""
    rows = []
    ok = True
    for name, value in numbers.items():
        lim = limits.get(name)
        rows.append((name, value, lim))
        if lim is None or not (value <= lim):
            ok = False
    return ok, rows


def check(sess) -> dict:
    """The numbers of one run: the program's check frames against the
    reference."""
    prog = program_side(sess)
    ref = reference_side(sess, prog)
    return compare(prog, ref, sess.traffic.clicks is not None,
                   sess.traffic.character is not None)
