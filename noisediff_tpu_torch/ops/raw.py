"""Raw Bayer ISP math as tensor functions.

Port of noisediff_tpu/ops/raw.py (reference `utils/raw_util.py`):
  - pack_raw            (:17-35)   Bayer RGGB -> 4ch half-res, BL 512, /(16383-512)
  - pack_np_raw         (:39-49)   pack without black-level handling (`pack_bayer`)
  - pack_raw_withoutclip(:52-66)   /16383 variant
  - unpack_raw          (:69-84)   4ch -> Bayer uint16 DN
  - get_darkshading     (:87-94)   PMN darkshading model ds_k*iso + ds_b + BLE
  - pack_raw_withdarkshading (:112-139)
  - camera noise tables (:377-462), which Shot-Noise Augmentation
    (ops/sna.py) and the Poisson-Gaussian dataset read.

Packed images are HWC (channels last) with any leading batch dims, as in
the JAX package. Channel order is R, G1, B, G2:
  out[...,0]=bayer[0::2,0::2]  out[...,1]=bayer[0::2,1::2]
  out[...,2]=bayer[1::2,1::2]  out[...,3]=bayer[1::2,0::2]
"""
from __future__ import annotations

import numpy as np
import torch

BLACK_LEVEL = 512.0
WHITE_POINT = 16383.0
SCALE = WHITE_POINT - BLACK_LEVEL  # 15871


def pack_bayer(bayer: torch.Tensor) -> torch.Tensor:
    """(..., H, W) Bayer mosaic -> (..., H/2, W/2, 4) [R, G1, B, G2]; a pure
    rearrangement (reference `pack_np_raw`, raw_util.py:39-49)."""
    return torch.stack([bayer[..., 0::2, 0::2], bayer[..., 0::2, 1::2],
                        bayer[..., 1::2, 1::2], bayer[..., 1::2, 0::2]], dim=-1)


def pack_raw(bayer: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    """Black-level subtract, clamp at 0, optionally normalise by
    (white - black), pack (raw_util.py:17-35)."""
    im = torch.clamp(bayer.float() - BLACK_LEVEL, min=0.0)
    if rescale:
        im = im / SCALE
    return pack_bayer(im)


def pack_raw_withoutclip(bayer: torch.Tensor) -> torch.Tensor:
    """/16383 variant with no black-level subtraction (raw_util.py:52-66)."""
    return pack_bayer(bayer.float() / WHITE_POINT)


def unpack_to_bayer(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bayer: (..., h, w, 4) -> (..., 2h, 2w), same units."""
    *lead, h, w, c = packed.shape
    if c != 4:
        raise ValueError(f"expected 4 channels, got {c}")
    top = torch.stack([packed[..., 0], packed[..., 1]], dim=-1)  # row 0: R, G1
    bottom = torch.stack([packed[..., 3], packed[..., 2]], dim=-1)  # row 1: G2, B
    quad = torch.stack([top, bottom], dim=-2)  # (..., h, w, 2, 2)
    return quad.movedim(-2, -3).reshape(*lead, 2 * h, 2 * w)


def unpack_raw(packed: torch.Tensor) -> torch.Tensor:
    """Normalised 4ch -> uint16 Bayer DN (raw_util.py:69-84)."""
    bayer = unpack_to_bayer(packed) * SCALE + BLACK_LEVEL
    return torch.clamp(bayer, 0, WHITE_POINT).to(torch.uint16)


def darkshading_from_kb(ds_k: torch.Tensor, ds_b: torch.Tensor, iso: float,
                        ble: float) -> torch.Tensor:
    """PMN dark-shading model: ds_k * iso + ds_b + BLE[iso] (raw_util.py:87-94),
    full-resolution Bayer-domain maps."""
    return ds_k * iso + ds_b + ble


def apply_darkshading(bayer_dn: torch.Tensor, darkshading: torch.Tensor) -> torch.Tensor:
    """Subtract a Bayer-domain dark-shading map from raw DN values."""
    return bayer_dn - darkshading


def pack_raw_withdarkshading(bayer_dn: torch.Tensor, darkshading: torch.Tensor,
                             ratio: float) -> torch.Tensor:
    """Test-time darkshading-corrected packing (raw_util.py:112-139):
    normalise, x ratio, clip to [0, 1], un-ratio, back to DN, subtract the
    darkshading, pack, black-level subtract, normalise. The round trip
    through the clip saturates highlights as the training data was."""
    im = (bayer_dn.float() - BLACK_LEVEL) / SCALE
    im = torch.clamp(im * ratio, 0.0, 1.0)
    im = im / ratio
    im = torch.clamp(im * SCALE + BLACK_LEVEL, 0.0, WHITE_POINT)
    im = im - darkshading
    out = pack_bayer(im)
    out = torch.clamp(out - BLACK_LEVEL, min=0.0)
    return out / SCALE


def remove_darkshading_packed(packed: torch.Tensor, darkshading_patch: torch.Tensor,
                              ratio) -> torch.Tensor:
    """Darkshading removal for a packed, ratio-amplified, normalised patch
    (dataset_denoising.py:80-118): unpack, un-ratio, to DN, clip, subtract
    the (cropped, Bayer-domain) darkshading patch, repack, black-level
    subtract, normalise, re-ratio, clip to [0, 1]."""
    ratio = torch.as_tensor(ratio, dtype=torch.float32, device=packed.device)
    bayer = unpack_to_bayer(packed) / ratio
    bayer = torch.clamp(bayer * SCALE + BLACK_LEVEL, 0.0, WHITE_POINT)
    bayer = bayer - darkshading_patch
    out = pack_bayer(bayer)
    out = torch.clamp(out - BLACK_LEVEL, min=0.0) / SCALE
    return torch.clamp(out * ratio, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Camera noise calibration tables (reference raw_util.py:377-462).
# ---------------------------------------------------------------------------

_CAM_NOISY_PARAMS = {
    "NikonD850": {
        "Kmin": 1.2, "Kmax": 2.4828, "lam": -0.26, "q": 1 / (2 ** 14),
        "wp": 16383, "bl": 512,
        "sigTLk": 0.906, "sigTLb": -0.6754, "sigTLsig": 0.035165,
        "sigRk": 0.8322, "sigRb": -2.3326, "sigRsig": 0.301333,
        "sigGsk": 0.8322, "sigGsb": -0.1754, "sigGssig": 0.035165,
    },
    "IMX686": {
        "Kmin": -0.19118, "Kmax": 2.16820, "lam": 0.102, "q": 1 / (2 ** 10),
        "wp": 1023, "bl": 64,
        "sigTLk": 0.85187, "sigTLb": 0.07991, "sigTLsig": 0.02921,
        "sigRk": 0.87611, "sigRb": -2.11455, "sigRsig": 0.03274,
        "sigGsk": 0.85187, "sigGsb": 0.67991, "sigGssig": 0.02921,
    },
    "SonyA7S2_lowISO": {
        "Kmin": -1.67214, "Kmax": 0.42228, "lam": -0.026, "q": 1 / (2 ** 14),
        "wp": 16383, "bl": 512,
        "sigRk": 0.78782, "sigRb": -0.34227, "sigRsig": 0.02832,
        "sigTLk": 0.74043, "sigTLb": 0.86182, "sigTLsig": 0.00712,
        "sigGsk": 0.82966, "sigGsb": 1.49343, "sigGssig": 0.00359,
        "sigReadk": 0.82879, "sigReadb": 1.50601, "sigReadsig": 0.00362,
        "uReadk": 0.01472, "uReadb": 0.01129, "uReadsig": 0.00034,
    },
    "SonyA7S2_highISO": {
        "Kmin": 0.64567, "Kmax": 2.51606, "lam": -0.025, "q": 1 / (2 ** 14),
        "wp": 16383, "bl": 512,
        "sigRk": 0.62945, "sigRb": -1.51040, "sigRsig": 0.02609,
        "sigTLk": 0.74901, "sigTLb": -0.12348, "sigTLsig": 0.00638,
        "sigGsk": 0.82878, "sigGsb": 0.44162, "sigGssig": 0.00153,
        "sigReadk": 0.82645, "sigReadb": 0.45061, "sigReadsig": 0.00156,
        "uReadk": 0.00385, "uReadb": 0.00674, "uReadsig": 0.00039,
    },
    "CRVD": {
        "Kmin": 1.31339, "Kmax": 3.95448, "lam": 0.015, "q": 1 / (2 ** 12),
        "wp": 4095, "bl": 240,
        "sigRk": 0.93368, "sigRb": -2.19692, "sigRsig": 0.02473,
        "sigGsk": 0.95387, "sigGsb": 0.01552, "sigGssig": 0.00855,
        "sigTLk": 0.95495, "sigTLb": 0.01618, "sigTLsig": 0.00790,
    },
}

# Per-ISO SonyA7S2 max-K calibration (raw_util.py:422-452): ISOs 50..25600.
# Columns: Kmax, lam, sigGs, sigGssig, sigTL, sigTLsig, sigR, sigRsig, biassig.
# q = 1/16384, wp = 16383, bl = 512 for all rows; bias = 0.
_SONY_ROWS = {
    50:    (0.047815, 0.1474653, 1.0164667, 0.005272454, 0.70727646, 0.004360543, 0.13997398, 0.0064381803, 0.010093017),
    64:    (0.0612032, 0.13243394, 1.0509665, 0.008081373, 0.71535635, 0.0056863446, 0.14346549, 0.006400559, 0.008690166),
    80:    (0.076504, 0.1121489, 1.180899, 0.011333668, 0.7799473, 0.009347968, 0.19540153, 0.008197397, 0.0107246125),
    100:   (0.09563, 0.14875287, 1.0067395, 0.0033682834, 0.70181876, 0.0037532174, 0.1391465, 0.006530218, 0.007235429),
    125:   (0.1195375, 0.12904578, 1.0279676, 0.007364685, 0.6961967, 0.0048687346, 0.14485553, 0.006731584, 0.008026363),
    160:   (0.153008, 0.094135, 1.1293099, 0.008340453, 0.7258587, 0.008032158, 0.19755602, 0.0082754735, 0.0101351),
    200:   (0.19126, 0.07902429, 1.2926387, 0.012171176, 0.8117464, 0.010250768, 0.22815849, 0.010726711, 0.011413908),
    250:   (0.239075, 0.051688068, 1.4345995, 0.01606571, 0.8630922, 0.013844714, 0.26271912, 0.0130637, 0.013569083),
    320:   (0.306016, 0.040700804, 1.7481371, 0.019626873, 1.0334468, 0.017629284, 0.3097104, 0.016202712, 0.017825918),
    400:   (0.38252, 0.0222538, 2.0595572, 0.024872316, 1.1816813, 0.02505812, 0.36209714, 0.01994737, 0.021005306),
    500:   (0.47815, -0.0031342343, 2.3956928, 0.030144656, 1.31772, 0.028629242, 0.42528257, 0.025104137, 0.02981831),
    640:   (0.612032, 0.002566592, 2.9662898, 0.045661453, 1.6474211, 0.04671843, 0.48839623, 0.031589635, 0.10000693),
    800:   (0.76504, -0.008199721, 3.5475867, 0.052318197, 1.9346539, 0.046128694, 0.5723769, 0.037824076, 0.025339302),
    1000:  (0.9563, -0.021061005, 4.2727833, 0.06972333, 2.2795107, 0.059203167, 0.6845563, 0.04879781, 0.027911892),
    1250:  (1.195375, -0.032423194, 5.177596, 0.092677385, 2.708437, 0.07622563, 0.8177013, 0.06162229, 0.03293372),
    1600:  (1.53008, -0.0441045, 6.29925, 0.1153261, 3.2283993, 0.09118158, 0.988786, 0.078567736, 0.03877672),
    2000:  (1.9126, -0.012963797, 2.653871, 0.015890995, 1.4356787, 0.02178686, 0.33124214, 0.018801652, 0.01570677),
    2500:  (2.39075, -0.027097283, 3.200225, 0.019307792, 1.6897862, 0.025873765, 0.38264316, 0.023769397, 0.018728448),
    3200:  (3.06016, -0.034863412, 3.9193838, 0.02649232, 2.0417721, 0.032873377, 0.44543457, 0.030114045, 0.021355819),
    4000:  (3.8252, -0.043700505, 4.8015847, 0.03781628, 2.4629273, 0.042401053, 0.52347374, 0.03929801, 0.026152484),
    5000:  (4.7815, -0.053150143, 5.8995814, 0.0625814, 2.9761007, 0.061326735, 0.6190265, 0.05335372, 0.058574405),
    6400:  (6.12032, -0.07517104, 7.1163535, 0.08435366, 3.4502964, 0.08226275, 0.7218788, 0.0642334, 0.059074216),
    8000:  (7.6504, -0.08208357, 8.916516, 0.12763213, 4.269624, 0.13381928, 0.87760293, 0.07389065, 0.084842026),
    10000: (9.563, -0.073289566, 11.291476, 0.1639773, 5.495318, 0.16279395, 1.0522343, 0.094359785, 0.107438326),
    12800: (12.24064, -0.06495205, 14.245901, 0.17283991, 7.038261, 0.18822834, 1.2749791, 0.120479785, 0.0944684),
    16000: (15.3008, -0.060692135, 17.833515, 0.19809262, 8.877547, 0.23338738, 1.5559287, 0.15791349, 0.09725099),
    20000: (19.126, -0.060213074, 22.084776, 0.21820943, 11.002351, 0.28806436, 1.8810822, 0.18937257, 0.4984733),
    25600: (24.48128, -0.09089118, 25.853043, 0.35371417, 12.175712, 0.4215717, 2.2760193, 0.2609267, 0.37568903),
}

SONY_A7S2_ISO_TABLE = np.array(sorted(_SONY_ROWS.keys()), dtype=np.int32)


def get_camera_noisy_params(camera_type: str | None = None) -> dict:
    """Per-camera K/sigma calibration ranges (raw_util.py:377-417); unknown
    cameras fall back to NikonD850, as in the reference."""
    if camera_type in _CAM_NOISY_PARAMS:
        return dict(_CAM_NOISY_PARAMS[camera_type])
    return dict(_CAM_NOISY_PARAMS["NikonD850"])


def get_camera_noisy_params_max(camera_type: str | None = None) -> dict | None:
    """Per-ISO SonyA7S2 calibration (raw_util.py:422-462); None if unknown."""
    if camera_type == "IMX686_6400":
        return {
            "Kmax": 8.74253, "sigGs": 12.8901, "sigGssig": 0.03,
            "sigTL": 12.8901, "lam": 0.015, "sigR": 0,
            "q": 1 / (2 ** 10), "wp": 1023, "bl": 64, "bias": -0.56896687,
        }
    if camera_type is None or not camera_type.startswith("SonyA7S2_"):
        return None
    try:
        iso = int(camera_type.split("_", 1)[1])
    except ValueError:
        return None
    row = _SONY_ROWS.get(iso)
    if row is None:
        return None
    kmax, lam, siggs, siggssig, sigtl, sigtlsig, sigr, sigrsig, biassig = row
    return {
        "Kmax": kmax, "lam": lam, "sigGs": siggs, "sigGssig": siggssig,
        "sigTL": sigtl, "sigTLsig": sigtlsig, "sigR": sigr, "sigRsig": sigrsig,
        "bias": 0, "biassig": biassig,
        "q": 6.103515625e-05, "wp": 16383, "bl": 512,
    }


def sony_kmax_array() -> np.ndarray:
    """Kmax of each ISO of SONY_A7S2_ISO_TABLE, in its order (float32)."""
    return np.array([_SONY_ROWS[int(i)][0] for i in SONY_A7S2_ISO_TABLE], dtype=np.float32)
