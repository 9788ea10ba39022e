"""Interactive comparison demo in PyTorch: DDIM vs IADB vs BNDM on the same
noise.

Counterpart of ``bndm_tpu/cli/demo.py`` (the reference's ``gradio_bndm.py``):
loads the three church-64 models (the DDIM baseline, IADB on gaussian
noise, BNDM on gaussianBN), denoises the SAME initial white noise with each,
and shows the intermediate states. Three front ends over ``generate_all``:

  * ``--serve_http``: a stdlib ``http.server`` front end (slider page,
    per-frame PNGs, and POST /api/generate, which samples the three again
    for a new seed);
  * the gradio slider UI where gradio is installed (``--serve`` forces it);
  * else a static comparison panel PNG (method rows x step columns, drawn
    with PIL).

A model whose checkpoint is missing is random-init, with a warning. It runs
on CUDA unless ``--device=cpu`` is given.

  python -m bndm_tpu_torch.cli.demo --dataset=church_res64 --res=64 \\
      --scheduler_gamma=sigmoid --scheduler_param=1000 --nb_steps=50
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="church_res64")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--train_or_test", type=str, default="test")
    p.add_argument("--scheduler_gamma", type=str, default="sigmoid")
    p.add_argument("--scheduler_param", type=float, default=1000)
    p.add_argument("--scheduler_param_s", type=float, default=0)
    p.add_argument("--scheduler_param_e", type=float, default=3)
    p.add_argument("--nb_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bluenoise_dir", type=str, default="bluenoise")
    p.add_argument("--output", type=str, default="demo_comparison.png")
    p.add_argument("--tiny_model", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--serve", action="store_true", help="force the gradio UI")
    p.add_argument("--serve_http", action="store_true",
                   help="serve the comparison UI over stdlib http.server (no gradio needed)")
    p.add_argument("--port", type=int, default=7860, help="--serve_http port (0 = ephemeral)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p.parse_args(argv)


def _model(opt, out_channel, ckpt_path, device):
    """A UNet on ``device`` in eval mode: the checkpoint's weights where it
    exists (``model.npz``, the JAX package's layout), else random-init from
    seed 0."""
    from bndm_tpu_torch.cli.common import load_params
    from bndm_tpu_torch.models.convert import state_dict_from_flax
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, unet_config_for_res

    if opt.tiny_model:
        cfg = UNet2DConfig(
            in_channels=3, out_channels=out_channel, block_out_channels=(8, 16),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
            attention_head_dim=4, norm_num_groups=4, dtype=opt.compute_dtype,
        )
    else:
        cfg = unet_config_for_res(opt.res, 3, out_channel, dtype=opt.compute_dtype)
    torch.manual_seed(0)
    model = UNet2D(cfg, device=device)
    if ckpt_path and os.path.exists(ckpt_path):
        model.load_state_dict(state_dict_from_flax(load_params(ckpt_path)), strict=True)
    else:
        print(f"WARNING: checkpoint {ckpt_path} not found; random init "
              "(demo still shows the pipeline plumbing)")
    return model.eval()


def load_all(opt, device):
    """Load the three models ONCE, as the reference demo does at startup
    (later requests only sample again). Returns name -> model."""
    ds = opt.dataset
    return {
        "DDIM": _model(opt, 3, f"results_gaussianBN/ddim_{ds}/unet/model.npz", device),
        "IADB": _model(opt, 3, f"results_gaussianBN/{ds}_gaussian_linear_outc3_seed0/model.npz",
                       device),
        "BNDM": _model(opt, 6, f"results_gaussianBN/{ds}_gaussianBN_{opt.scheduler_gamma}"
                               "_outc6_seed0/model.npz", device),
    }


def generate_all(opt, loaded):
    """Run the three methods from the same x0 (seeded by ``opt.seed``);
    returns name -> frames, a numpy (n_frames, C, H, W) in [-1, 1]-ish
    (the intermediates unnormalized)."""
    from bndm_tpu_torch.cli.common import make_generator
    from bndm_tpu_torch.samplers.ddim import DDIMScheduler, sample_ddim
    from bndm_tpu_torch.samplers.iadb import sample_iadb

    device = next(loaded["DDIM"].parameters()).device
    x0 = torch.randn((1, 3, opt.res, opt.res), generator=make_generator(device, opt.seed),
                     device=device)
    log_freq = max(opt.nb_steps // 10, 1)
    sp = (opt.scheduler_param, opt.scheduler_param_s, opt.scheduler_param_e)
    _, ddim = sample_ddim(loaded["DDIM"], x0, scheduler=DDIMScheduler(),
                          num_inference_steps=opt.nb_steps, collect_frames=True)
    _, iadb = sample_iadb(loaded["IADB"], x0, nb_steps=opt.nb_steps, collect_frames=True,
                          log_freq=log_freq)
    _, bndm = sample_iadb(loaded["BNDM"], x0, nb_steps=opt.nb_steps,
                          scheduler_gamma=opt.scheduler_gamma, gamma_params=sp, two_head=True,
                          collect_frames=True, log_freq=log_freq)
    return {name: frames[:, 0].float().cpu().numpy()
            for name, frames in (("DDIM", ddim), ("IADB", iadb), ("BNDM", bndm))}


def _to_img(frame, final):
    a = np.asarray(frame)
    if final:
        a = np.clip((a + 1.0) / 2.0, 0, 1)
    else:
        a = (a - a.min()) / max(a.max() - a.min(), 1e-8)
    return np.transpose(a, (1, 2, 0))


def save_panel(results, path):
    """The static comparison panel: one row per method, one column per
    frame (each frame at twice its size), the method's name at the left of
    its row; drawn with PIL."""
    from PIL import Image, ImageDraw

    cols = max(len(v) for v in results.values())
    h, w = next(iter(results.values())).shape[-2:]
    th, tw, label, pad = 2 * h, 2 * w, 56, 4
    panel = Image.new("RGB", (label + cols * (tw + pad), len(results) * (th + pad)), "white")
    draw = ImageDraw.Draw(panel)
    for r, (name, frames) in enumerate(results.items()):
        y = r * (th + pad)
        draw.text((4, y + th // 2 - 5), name, fill="black")
        for c, frame in enumerate(frames):
            tile = Image.fromarray((_to_img(frame, final=(c == len(frames) - 1)) * 255)
                                   .astype(np.uint8)).resize((tw, th), Image.NEAREST)
            panel.paste(tile, (label + c * (tw + pad), y))
    panel.save(path)
    print(f"comparison panel written to {path}")


_PAGE = """<!doctype html>
<html><head><title>BNDM: DDIM vs IADB vs BNDM</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; background: #fafafa; }}
 .row {{ display: flex; gap: 2em; align-items: center; }}
 figure {{ text-align: center; }}
 img {{ width: 256px; image-rendering: pixelated; border: 1px solid #ccc; }}
 input[type=range] {{ width: 40em; }}
</style></head><body>
<h2>BNDM: denoising comparison (same initial noise)</h2>
<div class="row" id="imgs">{figs}</div>
<p><label>denoising frame <input type="range" id="step" min="0" max="{nmax}"
 value="{nmax}" oninput="upd()"> <span id="stepv">{nmax}</span></label></p>
<p><label>seed <input type="number" id="seed" value="0" style="width:5em">
 </label> <button onclick="regen()">regenerate</button>
 <span id="status"></span></p>
<script>
function upd() {{
  const s = document.getElementById('step').value;
  document.getElementById('stepv').textContent = s;
  for (const im of document.querySelectorAll('img'))
    im.src = '/frame/' + im.dataset.method + '/' + s + '.png?v=' + Date.now();
}}
async function regen() {{
  document.getElementById('status').textContent = 'sampling...';
  const seed = document.getElementById('seed').value;
  await fetch('/api/generate?seed=' + seed, {{method: 'POST'}});
  document.getElementById('status').textContent = '';
  upd();
}}
</script></body></html>"""


def _png_bytes(frame, final):
    """One (C, H, W) frame as PNG bytes (PIL, no matplotlib)."""
    import io

    from PIL import Image

    a = (_to_img(frame, final) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


def make_http_server(opt, results, loaded):
    """Build (not start) a ThreadingHTTPServer serving the comparison UI.

    Endpoints: GET / (the slider page), GET /api/meta (methods and frame
    counts), GET /frame/<method>/<idx>.png, POST /api/generate?seed=N
    (samples the three models again; the loaded models are reused). The
    server has ``.server_address``; call ``.serve_forever()`` or drive it
    from a thread. Requests that sample run one at a time."""
    import copy
    import http.server
    import json
    import threading
    import urllib.parse

    state = {"results": results}
    sampling = threading.Lock()  # one device, one sampling request at a time

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            res = state["results"]
            path = urllib.parse.urlparse(self.path).path
            if path in ("/", "/index.html"):
                nmax = max(len(v) for v in res.values()) - 1
                figs = "".join(
                    f'<figure><img data-method="{m}" src="/frame/{m}/{nmax}.png">'
                    f"<figcaption>{m}</figcaption></figure>" for m in res)
                self._send(200, _PAGE.format(figs=figs, nmax=nmax).encode())
            elif path == "/api/meta":
                self._send(200, json.dumps({m: len(v) for m, v in res.items()}).encode(),
                           "application/json")
            elif path.startswith("/frame/"):
                try:
                    _, _, method, idx = path.split("/")
                    frames = res[method]
                    idx = min(int(idx.split(".")[0]), len(frames) - 1)
                    self._send(200, _png_bytes(frames[idx], final=(idx == len(frames) - 1)),
                               "image/png")
                except (KeyError, ValueError, IndexError):
                    self._send(404, b"not found", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            q = urllib.parse.urlparse(self.path)
            if q.path != "/api/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                seed = int(urllib.parse.parse_qs(q.query).get("seed", ["0"])[0])
            except ValueError:
                self._send(400, b'{"ok": false, "error": "seed must be an integer"}',
                           "application/json")
                return
            o = copy.copy(opt)
            o.seed = seed
            try:
                with sampling:
                    state["results"] = generate_all(o, loaded)
            except Exception as e:  # noqa: BLE001 -- reported to the client, not hung
                self._send(500, json.dumps({"ok": False, "error": str(e)}).encode(),
                           "application/json")
                return
            self._send(200, b'{"ok": true}', "application/json")

    return http.server.ThreadingHTTPServer(("127.0.0.1", opt.port), Handler)


def serve_http(opt, results, loaded):
    srv = make_http_server(opt, results, loaded)
    host, port = srv.server_address[:2]
    print(f"serving comparison UI at http://{host}:{port}/ (ctrl-c to stop)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def serve_gradio(results):
    import gradio as gr

    names = list(results)
    n = max(len(v) for v in results.values())

    def show(step_idx):
        return [_to_img(results[name][min(int(step_idx), len(results[name]) - 1)],
                        final=(int(step_idx) >= len(results[name]) - 1)) for name in names]

    with gr.Blocks(title="BNDM: DDIM vs IADB vs BNDM") as ui:
        slider = gr.Slider(0, n - 1, value=n - 1, step=1, label="denoising frame")
        imgs = [gr.Image(label=name) for name in names]
        slider.change(show, inputs=slider, outputs=imgs)
    ui.launch()


def main(argv=None):
    from bndm_tpu_torch.cli.common import disable_tf32, resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    disable_tf32()
    loaded = load_all(opt, device)
    results = generate_all(opt, loaded)
    if opt.serve_http:
        serve_http(opt, results, loaded)
        return results
    try:
        import gradio  # noqa: F401

        has_gradio = True
    except ImportError:
        has_gradio = False
    if has_gradio or opt.serve:
        serve_gradio(results)
    else:
        save_panel(results, opt.output)
    return results


if __name__ == "__main__":
    main()
