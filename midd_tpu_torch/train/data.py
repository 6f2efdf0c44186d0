"""Host-side data pipeline (counterpart of ``midd_tpu/train/data.py``):
paired clean/noisy X-ray loading, the matching heuristics, paired
augmentation, synthetic noise, a batch iterator and a background prefetch to
the device.

The numpy/PIL code is the port's own copy of the JAX package's, so one seed
gives the same arrays. Batches stay NHWC fp32 numpy in [0, 1] on the host;
``to_device`` turns them into NCHW tensors once, at the device boundary.

Not ported yet: the native C++ resize (``use_native``, ``midd_tpu/native.py``)
and ``visualize_pairs`` (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

# ---------------------------------------------------------------------------
# Noise synthesis
# ---------------------------------------------------------------------------


def add_gaussian_noise(img: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    return np.clip(img + rng.normal(0.0, sigma, img.shape).astype(np.float32), 0, 1)


def add_speckle_noise(img: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Multiplicative speckle: x * (1 + n), n ~ N(0, sigma)."""
    return np.clip(img * (1.0 + rng.normal(0.0, sigma, img.shape).astype(np.float32)), 0, 1)


def add_poisson_noise(img: np.ndarray, peak: float, rng: np.random.Generator) -> np.ndarray:
    """Quantum/Poisson noise: photon counts at the given peak intensity."""
    counts = rng.poisson(np.clip(img, 0, 1) * peak).astype(np.float32)
    return np.clip(counts / peak, 0, 1)


NOISE_FNS = {
    "gaussian": lambda x, rng: add_gaussian_noise(x, 0.1, rng),
    "speckle": lambda x, rng: add_speckle_noise(x, 0.2, rng),
    "poisson": lambda x, rng: add_poisson_noise(x, 30.0, rng),
}

# ---------------------------------------------------------------------------
# Pair discovery and loading
# ---------------------------------------------------------------------------


def match_pairs(
    clear_dir: str,
    noisy_dirs: Sequence[str],
    max_samples: int = 500,
    substring_glob: bool = False,
) -> List[Tuple[str, str]]:
    """Find (clean, noisy) file pairs with the reference's heuristics: exact
    name or a ``Gauss_``/``gauss_``/``noisy_``/``speckle_`` prefix; the
    hybrid's ``*stem*`` glob with ``substring_glob``."""
    clear_files = sorted(glob.glob(os.path.join(clear_dir, "*.*")))[:max_samples]
    if not clear_files:
        raise ValueError(f"No images in {clear_dir}")
    if isinstance(noisy_dirs, str):
        noisy_dirs = [noisy_dirs]

    pairs: List[Tuple[str, str]] = []
    for c in clear_files:
        base = os.path.basename(c)
        stem = os.path.splitext(base)[0]
        found = None
        for nd in noisy_dirs:
            if substring_glob:  # hybrid variant (hybrid3diffusionspeed.py:59-60)
                cands = sorted(glob.glob(os.path.join(nd, f"*{stem}*")))
                if os.path.exists(os.path.join(nd, base)):
                    cands.append(os.path.join(nd, base))
            else:
                cands = [os.path.join(nd, f"{prefix}{base}")
                         for prefix in ("", "Gauss_", "gauss_", "noisy_", "speckle_")]
            found = next((cand for cand in cands if os.path.exists(cand)), None)
            if found:
                break
        if found:
            pairs.append((c, found))
    return pairs


def load_image(path: str, img_size: int) -> np.ndarray:
    """Grayscale load + BICUBIC resize (PIL, the reference's library) +
    [0,1] fp32 HWC(1)."""
    img = Image.open(path).convert("L")
    img = img.resize((img_size, img_size), Image.BICUBIC)
    return (np.asarray(img, np.float32) / 255.0)[..., None]


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------


@dataclass
class AugmentConfig:
    """Defaults = NafNet/NafnetModel.py:52-62."""

    rotation_prob: float = 0.5
    rotation_range: Tuple[float, float] = (-15.0, 15.0)
    flip_prob: float = 0.5
    vflip_prob: float = 0.3
    brightness_prob: float = 0.3
    brightness_range: Tuple[float, float] = (0.9, 1.1)
    contrast_prob: float = 0.3
    contrast_range: Tuple[float, float] = (0.9, 1.1)
    noise_prob: float = 0.2
    noise_std: float = 0.01


def augment_pair(
    clean: np.ndarray, noisy: np.ndarray, cfg: AugmentConfig, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Identical geometric/photometric transforms on both images; noise
    injection on the noisy image only (NafNet:139-142)."""
    if rng.random() < cfg.rotation_prob:
        angle = rng.uniform(*cfg.rotation_range)
        clean = _rotate(clean, angle)
        noisy = _rotate(noisy, angle)
    if rng.random() < cfg.flip_prob:
        clean, noisy = clean[:, ::-1], noisy[:, ::-1]
    if rng.random() < cfg.vflip_prob:
        clean, noisy = clean[::-1], noisy[::-1]
    if rng.random() < cfg.brightness_prob:
        f = rng.uniform(*cfg.brightness_range)
        clean = np.clip(clean * f, 0, 1)
        noisy = np.clip(noisy * f, 0, 1)
    if rng.random() < cfg.contrast_prob:
        f = rng.uniform(*cfg.contrast_range)
        clean = np.clip((clean - clean.mean()) * f + clean.mean(), 0, 1)
        noisy = np.clip((noisy - noisy.mean()) * f + noisy.mean(), 0, 1)
    if rng.random() < cfg.noise_prob:
        noisy = np.clip(
            noisy + rng.normal(0, cfg.noise_std, noisy.shape).astype(np.float32), 0, 1
        )
    return np.ascontiguousarray(clean), np.ascontiguousarray(noisy)


def _rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """torchvision.functional.rotate defaults: nearest resample, no expand,
    zero fill."""
    pil = Image.fromarray((img[..., 0] * 255).astype(np.uint8), mode="L")
    pil = pil.rotate(angle, resample=Image.NEAREST, expand=False, fillcolor=0)
    return (np.asarray(pil, np.float32) / 255.0)[..., None]


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


class _SeededItems:
    """Per-item generators spawned from one seeded generator under a lock:
    ``dataset[i]`` takes the next one. ``batches`` spawns them in the
    epoch's order itself and hands each to ``item``, so that the item at a
    given place of the epoch gets the same draws whether the items are built
    on a thread pool or not, and on whichever data-parallel rank builds it."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    def _item_rng(self) -> np.random.Generator:
        with self._rng_lock:
            return np.random.default_rng(int(self.rng.integers(2**63)))

    def item(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.item(idx, self._item_rng())


class PairedXRayDataset(_SeededItems):
    """Disk-backed paired dataset (the reference's XRayDataset family)."""

    def __init__(
        self,
        clear_dir: str,
        noisy_dirs: Sequence[str],
        img_size: int = 512,
        max_samples: int = 500,
        is_train: bool = True,
        augment: AugmentConfig | None = None,
        substring_glob: bool = False,
        seed: int = 42,
    ):
        super().__init__(seed)
        self.pairs = match_pairs(clear_dir, noisy_dirs, max_samples, substring_glob)
        if not self.pairs:
            raise ValueError("No matching clean/noisy pairs found")
        self.img_size = img_size
        self.is_train = is_train
        self.augment = augment if augment is not None else AugmentConfig()

    def __len__(self) -> int:
        return len(self.pairs)

    def item(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        c, n = self.pairs[idx]
        clean = load_image(c, self.img_size)
        noisy = load_image(n, self.img_size)
        if self.is_train:
            clean, noisy = augment_pair(clean, noisy, self.augment, rng)
        return clean, noisy


class SyntheticPairedDataset(_SeededItems):
    """In-memory dataset that synthesises the noisy image from each clean one
    (the reference's noise types, README.md:15)."""

    def __init__(
        self,
        clean_images: np.ndarray,  # (N,H,W,1) in [0,1]
        noise_type: str = "speckle",
        is_train: bool = True,
        augment: AugmentConfig | None = None,
        seed: int = 42,
    ):
        super().__init__(seed)
        self.clean = np.asarray(clean_images, np.float32)
        self.noise_fn = NOISE_FNS[noise_type]
        self.is_train = is_train
        self.augment = augment if augment is not None else AugmentConfig()

    def __len__(self) -> int:
        return self.clean.shape[0]

    def item(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        clean = self.clean[idx]
        noisy = self.noise_fn(clean, rng)
        if self.is_train:
            clean, noisy = augment_pair(clean, noisy, self.augment, rng)
        return clean, noisy


# ---------------------------------------------------------------------------
# Batches and the device boundary
# ---------------------------------------------------------------------------


def batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    num_workers: int = 0,
    rows: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of (clean, noisy) NHWC numpy batches. ``num_workers > 0``
    assembles items on a thread pool (PIL decode releases the GIL).
    ``rows=(start, n)``: build only rows [start, start + n) of each batch,
    a data-parallel rank's share (``parallel.process_batch_slice``), each
    item as the whole batch would have it (a ``_SeededItems`` dataset's
    generators are spawned for every item of the batch, in order)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order)
    end = n - n % batch_size if drop_last else n
    if rows is not None and not drop_last:
        raise ValueError("rows: each rank's share of a batch needs drop_last")
    first, count = rows if rows is not None else (0, batch_size)

    def calls(start):
        idxs = [int(i) for i in order[start : start + batch_size]]
        keep = range(first, min(first + count, len(idxs)))
        if isinstance(dataset, _SeededItems):
            rngs = [dataset._item_rng() for _ in idxs]
            return [lambda k=k: dataset.item(idxs[k], rngs[k]) for k in keep]
        return [lambda k=k: dataset[idxs[k]] for k in keep]

    def stack(items):
        return np.stack([c for c, _ in items]), np.stack([x for _, x in items])

    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for start in range(0, end, batch_size):
                yield stack(list(pool.map(lambda call: call(), calls(start))))
        return

    for start in range(0, end, batch_size):
        yield stack([call() for call in calls(start)])


def to_device(batch: Tuple[np.ndarray, ...], device: torch.device) -> Tuple[torch.Tensor, ...]:
    """NHWC numpy arrays -> NCHW fp32 tensors on ``device``. For a CUDA
    device the host copy is pinned and the transfer is ``non_blocking``."""
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t.permute(0, 3, 1, 2).contiguous())
    return tuple(out)


def prefetch_to_device(iterator, device: torch.device, size: int = 2):
    """Overlap host batch assembly and the host-to-device copy with device
    compute: a background thread keeps ``size`` batches in flight, each
    already moved by ``to_device``. The copies go on the device's default
    stream, so the consumer's kernels are ordered after them. An exception
    in the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    failure: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(to_device(item, device))
        except BaseException as e:  # noqa: BLE001  handed to the consumer below
            failure.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        if failure:
            raise failure[0]
    finally:
        stop.set()
        while t.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
