"""Single-file web UI of the port's server, served at ``GET /ui`` (the
port's own copy of ``midd_tpu/serve/static_ui.py``): drag-drop upload and
``POST /denoise``, the original and the four outputs in a grid with
per-model download and preview, a before/after comparison slider, a PSNR
badge per model against the uploaded image (computed in the browser),
download-all, and an about section.
"""

UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>X-Ray Denoising — GPU</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 0; background: #0f1217; color: #e6e8eb; }
  header { padding: 24px 32px; border-bottom: 1px solid #232832; }
  h1 { margin: 0; font-size: 20px; } h1 span { color: #6cb6ff; }
  p.sub { color: #9aa4b2; margin: 6px 0 0; font-size: 13px; }
  main { padding: 24px 32px; }
  #drop { border: 2px dashed #39414e; border-radius: 12px; padding: 40px;
          text-align: center; cursor: pointer; transition: border-color .2s; }
  #drop.hover { border-color: #6cb6ff; }
  #status { margin: 16px 0; color: #9aa4b2; font-size: 14px; min-height: 20px; }
  .grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(240px, 1fr));
          gap: 16px; margin-top: 16px; }
  .card { background: #161b22; border: 1px solid #232832; border-radius: 10px;
          padding: 12px; position: relative; }
  .card h3 { margin: 0 0 8px; font-size: 14px; color: #9aa4b2; font-weight: 600; }
  .card img { width: 100%; border-radius: 6px; background: #000; }
  .card a, .card button.act { display: inline-block; margin: 8px 6px 0 0; font-size: 12px;
          color: #6cb6ff; background: none; border: 1px solid #39414e; border-radius: 6px;
          padding: 3px 8px; cursor: pointer; text-decoration: none; }
  .badge { position: absolute; top: 10px; right: 10px; background: #1f6feb;
           color: #fff; font-size: 11px; border-radius: 10px; padding: 2px 8px; }
  .spinner { margin: 40px auto; width: 28px; height: 28px; border: 3px solid #39414e;
             border-top-color: #6cb6ff; border-radius: 50%; animation: spin 1s linear infinite; }
  @keyframes spin { to { transform: rotate(360deg); } }
  /* before/after comparison slider */
  #compare { display: none; margin-top: 28px; }
  #compare h2 { font-size: 16px; color: #9aa4b2; }
  .cmp-wrap { position: relative; max-width: 640px; border-radius: 10px; overflow: hidden; }
  .cmp-wrap img { display: block; width: 100%; }
  .cmp-wrap img.top { position: absolute; inset: 0; clip-path: inset(0 0 0 50%); }
  .cmp-divider { position: absolute; top: 0; bottom: 0; width: 2px; background: #6cb6ff;
                 left: 50%; pointer-events: none; }
  .cmp-label { position: absolute; top: 8px; font-size: 11px; background: rgba(0,0,0,.55);
               padding: 2px 8px; border-radius: 8px; }
  #cmp-slider { width: 100%; max-width: 640px; margin-top: 8px; }
  #cmp-model, #download-all { background: #161b22; color: #e6e8eb; border: 1px solid #39414e;
               border-radius: 6px; padding: 4px 10px; margin: 8px 8px 0 0; cursor: pointer; }
  /* about section */
  #about { margin-top: 36px; border-top: 1px solid #232832; padding-top: 20px;
           color: #9aa4b2; font-size: 13px; max-width: 860px; }
  #about h2 { color: #e6e8eb; font-size: 16px; }
  #about .cols { display: grid; grid-template-columns: repeat(auto-fit, minmax(200px, 1fr)); gap: 14px; }
</style>
</head>
<body>
<header>
  <h1>X-Ray Denoising <span>Hybrid Router · GPU</span></h1>
  <p class="sub">NAFNet fast path · conditional diffusion · expert UNet · learned hybrid fusion</p>
</header>
<main>
  <div id="drop">Drop an X-ray image here or click to choose<input id="file" type="file" accept="image/*" hidden/></div>
  <div id="status"></div>
  <div class="grid" id="results"></div>

  <div id="compare">
    <h2>Before / after comparison</h2>
    <select id="cmp-model" aria-label="comparison model"></select>
    <button id="download-all">Download all</button>
    <div class="cmp-wrap" id="cmp-wrap">
      <img id="cmp-under" alt="original"/>
      <img id="cmp-over" class="top" alt="denoised"/>
      <div class="cmp-divider" id="cmp-divider"></div>
      <span class="cmp-label" style="left:8px">original</span>
      <span class="cmp-label" style="right:8px" id="cmp-over-label">denoised</span>
    </div>
    <input id="cmp-slider" type="range" min="0" max="100" value="50" aria-label="comparison slider"/>
  </div>

  <div id="about">
    <h2>About the pipeline</h2>
    <div class="cols">
      <div><b>NAFNet</b> — 20.99M-param nonlinear activation-free restoration
        network: the fast high-fidelity path.</div>
      <div><b>Conditional diffusion</b> — 12.8M-param epsilon-prediction UNet,
        8-step conditioned reverse rollout on the GPU.</div>
      <div><b>Expert UNet</b> — 7.6M-param direct residual denoiser with
        BatchNorm and perceptual-loss training.</div>
      <div><b>Hybrid router</b> — a noise analyzer picks per-pixel fusion
        weights over the NAFNet and diffusion outputs.</div>
    </div>
    <p>Per-model PSNR badges are measured against the uploaded image
      (HIGHER = closer to the noisy input, i.e. LESS change; they quantify change, not ground-truth
      quality). All four models answer every request on one GPU.</p>
  </div>
</main>
<script>
const drop = document.getElementById('drop');
const fileInput = document.getElementById('file');
const statusEl = document.getElementById('status');
const results = document.getElementById('results');
const NAMES = { nafnet: 'NAFNet', diffusion: 'Diffusion (8-step)',
                expert: 'Expert UNet', hybrid: 'Hybrid Router' };
let lastOutputs = {};   // model -> dataURL
let origURL = null;

drop.onclick = () => fileInput.click();
drop.ondragover = e => { e.preventDefault(); drop.classList.add('hover'); };
drop.ondragleave = () => drop.classList.remove('hover');
drop.ondrop = e => { e.preventDefault(); drop.classList.remove('hover');
                     if (e.dataTransfer.files[0]) denoise(e.dataTransfer.files[0]); };
fileInput.onchange = () => { if (fileInput.files[0]) denoise(fileInput.files[0]); };

function card(key, title, src, psnr) {
  const badge = psnr ? `<span class="badge psnr-badge">${psnr.toFixed(2)} dB</span>` : '';
  const acts = src ? `<a href="${src}" download="${key}_denoised_xray.png">download</a>` +
    `<button class="act" onclick="window.open('${src}','_blank')">preview</button>` : '';
  const body = src ? `<img src="${src}"/>` : '<div class="spinner"></div>';
  return `<div class="card" id="card-${key}"><h3>${title}</h3>${badge}${body}${acts}</div>`;
}

function luminance(data, i) { return 0.299*data[i] + 0.587*data[i+1] + 0.114*data[i+2]; }

async function imageData(url, w, h) {
  const img = new Image();
  await new Promise((res, rej) => { img.onload = res; img.onerror = rej; img.src = url; });
  const c = document.createElement('canvas');
  c.width = w || img.naturalWidth; c.height = h || img.naturalHeight;
  const ctx = c.getContext('2d');
  ctx.drawImage(img, 0, 0, c.width, c.height);
  return ctx.getImageData(0, 0, c.width, c.height);
}

async function psnrVsOriginal(outURL) {
  // PSNR of the model output vs the UPLOADED image, on the luminance channel
  const a = await imageData(origURL);
  const b = await imageData(outURL, a.width, a.height);
  let mse = 0, n = a.width * a.height;
  for (let i = 0; i < n * 4; i += 4) {
    const d = luminance(a.data, i) - luminance(b.data, i);
    mse += d * d;
  }
  mse /= n;
  if (mse < 1e-10) return Infinity;
  return 10 * Math.log10(255 * 255 / mse);
}

function renderCompare() {
  const sel = document.getElementById('cmp-model');
  const avail = Object.keys(lastOutputs);
  if (!avail.length || !origURL) return;
  sel.innerHTML = avail.map(k => `<option value="${k}">${NAMES[k]}</option>`).join('');
  const pick = () => {
    document.getElementById('cmp-under').src = origURL;
    document.getElementById('cmp-over').src = lastOutputs[sel.value];
    document.getElementById('cmp-over-label').textContent = NAMES[sel.value];
  };
  sel.onchange = pick; pick();
  const slider = document.getElementById('cmp-slider');
  slider.oninput = () => {
    document.getElementById('cmp-over').style.clipPath = `inset(0 0 0 ${slider.value}%)`;
    document.getElementById('cmp-divider').style.left = `${slider.value}%`;
  };
  document.getElementById('download-all').onclick = () => {
    for (const k of avail) {
      const link = document.createElement('a');
      link.href = lastOutputs[k];
      link.download = `${k}_denoised_xray.png`;
      document.body.appendChild(link); link.click(); document.body.removeChild(link);
    }
  };
  document.getElementById('compare').style.display = 'block';
}

async function denoise(file) {
  statusEl.textContent = 'Denoising with all four models…';
  lastOutputs = {};
  origURL = URL.createObjectURL(file);
  results.innerHTML = card('original', 'Original', origURL, null);
  for (const k of Object.keys(NAMES)) results.innerHTML += card(k, NAMES[k], null, null);
  const form = new FormData();
  form.append('file', file);
  const t0 = performance.now();
  try {
    const resp = await fetch('/denoise', { method: 'POST', body: form });
    if (!resp.ok) throw new Error('HTTP ' + resp.status);
    const data = await resp.json();
    results.innerHTML = card('original', 'Original', origURL, null);
    for (const k of Object.keys(NAMES)) {
      if (data[k]) {
        const url = 'data:image/png;base64,' + data[k];
        lastOutputs[k] = url;
        let p = null;
        try { p = await psnrVsOriginal(url); } catch (e) {}
        results.innerHTML += card(k, NAMES[k], url, isFinite(p) ? p : null);
      } else {
        results.innerHTML += `<div class="card" id="card-${k}"><h3>${NAMES[k]}</h3><p>failed</p></div>`;
      }
    }
    renderCompare();
    statusEl.textContent = `Done in ${((performance.now()-t0)/1000).toFixed(2)}s`;
  } catch (err) {
    statusEl.textContent = 'Error: ' + err.message;
  }
}
</script>
</body>
</html>
"""
