"""Single-file web UI of the editing server, served at ``/`` by
`serving.api`.

The port's own copy of the JAX package's page (`videocof_tpu/serving/
webui.py`), which replaces the reference's gradio frontend
(`examples/app.py`, `videox_fun/ui/wan_ui.py:150-214`) with a page that
needs no dependency: upload a clip, type the edit instruction, and set
every knob the HTTP API honors (steps, guidance, seed, frames, sampler,
negative prompt, LoRA path and weight, TeaCache, cfg-skip, the MoE's
second guidance, text-to-video) and the model switch. The same form fields
post to the same JSON endpoints, the non-Wan families' embeddings-in
mode included (an ``embeddings_path``, answered once a family is switched
in).
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>VideoCoF — chain-of-frames video editing</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; background: #111; color: #eee;
         max-width: 880px; margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.4rem; } h1 span { color: #7ac; }
  fieldset { border: 1px solid #333; border-radius: 8px; margin: 1rem 0;
             padding: 1rem; }
  legend { color: #7ac; font-size: .85rem; padding: 0 .4rem; }
  label { display: block; margin: .6rem 0 .2rem; font-size: .9rem;
          color: #aaa; }
  input[type=text], input[type=number], select {
      width: 100%; padding: .45rem; background: #1a1a1a; color: #eee;
      border: 1px solid #444; border-radius: 6px; box-sizing: border-box; }
  input[type=checkbox] { transform: scale(1.2); margin-top: .6rem; }
  .row { display: grid; grid-template-columns: repeat(4, 1fr); gap: .8rem; }
  .row3 { display: grid; grid-template-columns: 2fr 1fr 1fr; gap: .8rem; }
  button { margin-top: 1rem; padding: .6rem 1.6rem; font-size: 1rem;
           background: #2a6; border: 0; border-radius: 6px; color: #fff;
           cursor: pointer; }
  button.secondary { background: #46a; font-size: .9rem;
                     padding: .45rem 1rem; }
  button:disabled { background: #444; }
  video { width: 100%; margin-top: 1rem; border-radius: 8px; }
  #status { margin-top: 1rem; color: #7ac; white-space: pre-wrap; }
</style>
</head>
<body>
<h1><span>VideoCoF</span> — see &rarr; reason &rarr; edit</h1>
<fieldset>
  <legend>Input</legend>
  <label>Source video (mp4)</label>
  <input type="file" id="video" accept="video/mp4">
  <label>Edit instruction (or generation prompt in t2v mode)</label>
  <input type="text" id="prompt"
         placeholder="remove the dog / replace the car with a boat / ...">
  <label>Negative prompt</label>
  <input type="text" id="negprompt" value="">
  <div class="row">
    <div><label>Text-to-video (no source)</label>
      <input type="checkbox" id="t2v"></div>
    <div><label>t2v height</label>
      <input type="number" id="t2v_h" value="480" step="16"></div>
    <div><label>t2v width</label>
      <input type="number" id="t2v_w" value="832" step="16"></div>
    <div><label>t2v frames</label>
      <input type="number" id="t2v_frames" value="81"></div>
  </div>
</fieldset>
<fieldset>
  <legend>Sampling</legend>
  <div class="row">
    <div><label>Steps</label>
      <input type="number" id="steps" value="4" min="1" max="50"></div>
    <div><label>Guidance</label>
      <input type="number" id="cfg" value="1.0" step="0.5"></div>
    <div><label>Guidance 2 (MoE)</label>
      <input type="number" id="cfg2" value="" step="0.5"
             placeholder="= guidance"></div>
    <div><label>Seed</label>
      <input type="number" id="seed" value="0"></div>
  </div>
  <div class="row">
    <div><label>Sampler</label>
      <select id="sampler">
        <option>Flow_Unipc</option>
        <option>Flow_DPM++</option>
        <option>Euler</option>
      </select></div>
    <div><label>Source frames</label>
      <input type="number" id="frames" value="33"></div>
    <div><label>Reasoning frames</label>
      <input type="number" id="rframes" value="4"></div>
    <div><label>CFG skip ratio</label>
      <input type="number" id="cfgskip" value="0" min="0" max="1"
             step="0.05"></div>
  </div>
</fieldset>
<fieldset>
  <legend>Acceleration &amp; adapters</legend>
  <div class="row">
    <div><label>TeaCache</label>
      <input type="checkbox" id="teacache"></div>
    <div><label>TeaCache threshold</label>
      <input type="number" id="tc_thresh" value="0.10" step="0.01"></div>
    <div><label>Skip-start steps</label>
      <input type="number" id="tc_start" value="5" min="0"></div>
    <div></div>
  </div>
  <div class="row3">
    <div><label>LoRA path (VIDEOCOF_MODEL_DIRS allowlist)</label>
      <input type="text" id="lora" placeholder="none"></div>
    <div><label>LoRA weight</label>
      <input type="number" id="lora_w" value="1.0" step="0.05"></div>
    <div></div>
  </div>
</fieldset>
<fieldset>
  <legend>Model</legend>
  <div class="row3">
    <div><label>Checkpoint path (VIDEOCOF_MODEL_DIRS allowlist)</label>
      <input type="text" id="model_path"
             placeholder="/models/Wan2.1-T2V-14B, a Wan2.2 MoE dir, or a CogVideoX/Flux/QwenImage dir"></div>
    <div style="align-self:end">
      <button class="secondary" id="switch">Switch model</button></div>
    <div></div>
  </div>
  <div class="row3">
    <div><label>Embeddings .npz path (CogVideoX/Flux/QwenImage — server-side,
        keys: text_embeddings[, negative_embeddings, pooled_projections])</label>
      <input type="text" id="emb_path" placeholder="assets/embeds.npz"></div>
    <div><label>Image height/width (uses t2v fields)</label>
      <input type="text" disabled value="&uarr; t2v height/width/frames"></div>
    <div></div>
  </div>
</fieldset>
<button id="go">Edit video</button>
<div id="status"></div>
<video id="out" controls style="display:none"></video>
<img id="outimg" style="display:none; width:100%; margin-top:1rem;
     border-radius:8px">
<script>
const $ = (id) => document.getElementById(id);
$("switch").onclick = async () => {
  const p = $("model_path").value;
  if (!p) { $("status").textContent = "enter a checkpoint path"; return; }
  $("switch").disabled = true;
  $("status").textContent = "switching model weights...";
  try {
    const r = await fetch("/videocof/update_diffusion_transformer", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({diffusion_transformer_path: p})});
    const j = await r.json();
    $("status").textContent = j.message;
  } catch (e) {
    $("status").textContent = "error: " + e;
  } finally {
    $("switch").disabled = false;
  }
};
$("go").onclick = async () => {
  const emb = $("emb_path").value;
  if (emb) {  // non-Wan family: embeddings-in contract
    $("go").disabled = true;
    $("status").textContent = "generating (embeddings-in family mode)...";
    const body = {
      embeddings_path: emb,
      seed_textbox: +$("seed").value,
      sample_step_slider: +$("steps").value,
      cfg_scale_slider: +$("cfg").value,
      height: +$("t2v_h").value, width: +$("t2v_w").value,
      num_frames: +$("t2v_frames").value,
    };
    try {
      const r = await fetch("/videocof/infer_forward", {
        method: "POST", headers: {"Content-Type": "application/json"},
        body: JSON.stringify(body)});
      const j = await r.json();
      if (j.message !== "Success") throw new Error(j.message);
      if (j.base64_encoding) {
        $("out").src = "data:video/mp4;base64," + j.base64_encoding;
        $("out").style.display = "block"; $("outimg").style.display = "none";
      } else if (j.base64_image) {
        $("outimg").src = "data:image/png;base64," + j.base64_image;
        $("outimg").style.display = "block"; $("out").style.display = "none";
      }
      $("status").textContent = "done (" + j.family + ")" +
        (j.base64_latents ? " — undecoded latents returned (no VAE resident)" : "");
    } catch (e) {
      $("status").textContent = "error: " + e;
    } finally {
      $("go").disabled = false;
    }
    return;
  }
  const t2v = $("t2v").checked;
  const f = $("video").files[0];
  if (!t2v && !f) { $("status").textContent = "pick a video first (or check text-to-video)"; return; }
  if (!$("prompt").value) { $("status").textContent = "type an instruction"; return; }
  $("go").disabled = true;
  $("status").textContent = "uploading + generating...";
  let b64 = null;
  if (!t2v) {
    const buf = await f.arrayBuffer();
    b64 = btoa(String.fromCharCode(...new Uint8Array(buf)));
  }
  const body = {
    prompt_textbox: $("prompt").value,
    seed_textbox: +$("seed").value,
    sample_step_slider: +$("steps").value,
    cfg_scale_slider: +$("cfg").value,
    sampler_dropdown: $("sampler").value,
    source_frames: +$("frames").value,
    reasoning_frames: +$("rframes").value,
    enable_teacache: $("teacache").checked,
    teacache_threshold: +$("tc_thresh").value,
    num_skip_start_steps: +$("tc_start").value,
    cfg_skip_ratio: +$("cfgskip").value,
    lora_model_path: $("lora").value || "none",
    lora_alpha_slider: +$("lora_w").value,
  };
  if (t2v) {
    body.t2v = true;
    body.height = +$("t2v_h").value;
    body.width = +$("t2v_w").value;
    body.num_frames = +$("t2v_frames").value;
  } else {
    body.source_video = b64;
  }
  if ($("negprompt").value) body.negative_prompt_textbox = $("negprompt").value;
  if ($("cfg2").value !== "") body.guidance_scale_2 = +$("cfg2").value;
  const t0 = performance.now();
  try {
    const r = await fetch("/videocof/infer_forward", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify(body)});
    const j = await r.json();
    if (j.message !== "Success") throw new Error(j.message);
    const dt = ((performance.now() - t0) / 1000).toFixed(1);
    $("status").textContent = `done in ${dt}s\\nprompt: ${j.prompt}`;
    const v = $("out");
    v.src = "data:video/mp4;base64," + j.base64_encoding;
    v.style.display = "block";
  } catch (e) {
    $("status").textContent = "error: " + e;
  } finally {
    $("go").disabled = false;
  }
};
</script>
</body>
</html>
"""
