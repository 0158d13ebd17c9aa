"""A reconstruction's first map as a DICOM series: magnitude windowed to
12-bit int16 (1st to 99th percentile), anonymised UIDs, one file a
(slice, phase).

Counterpart of the root `scripts/write_dcm.py` (the reference's
`write_dcm.py:18-236`), with its arguments. pydicom is imported only here,
and where it does not import the script writes the windowed pixels
(`series_int16.npz`) and `series_meta.json` in place of the series.

    python -m dl_swin_gan_tpu_torch.scripts.write_dcm \\
        runs/x/recon/synthetic_000_12accel.im --out-directory dcm/
"""

import argparse
import json
import os

import numpy as np

from dl_swin_gan_tpu_torch.scripts.eval import load_images


def window_int16(mag: np.ndarray) -> np.ndarray:
    """Window/level magnitude into int16 pixel values like the reference."""
    lo, hi = np.percentile(mag, 1), np.percentile(mag, 99)
    mag = np.clip((mag - lo) / (hi - lo + 1e-12), 0, 1)
    return (mag * 4095).astype(np.int16)


def write_series(pixels: np.ndarray, out_directory: str,
                 description: str) -> None:
    """pixels [slice, phase, y, x] int16 -> IM00001.dcm, ... (pydicom)."""
    from pydicom.dataset import Dataset, FileMetaDataset
    from pydicom.uid import ExplicitVRLittleEndian, generate_uid

    study_uid = generate_uid()
    series_uid = generate_uid()
    idx = 0
    for sl in range(pixels.shape[0]):
        for ph in range(pixels.shape[1]):
            idx += 1
            ds = Dataset()
            ds.PatientName = "ANON"
            ds.PatientID = "ANON"
            ds.StudyInstanceUID = study_uid
            ds.SeriesInstanceUID = series_uid
            ds.SOPInstanceUID = generate_uid()
            ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.4"  # MR
            ds.Modality = "MR"
            ds.SeriesDescription = description
            ds.InstanceNumber = idx
            ds.SliceLocation = float(sl)
            ds.Rows, ds.Columns = pixels.shape[-2:]
            ds.BitsAllocated = 16
            ds.BitsStored = 12
            ds.HighBit = 11
            ds.PixelRepresentation = 1
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.WindowCenter = 2048
            ds.WindowWidth = 4096
            ds.PixelData = pixels[sl, ph].tobytes()
            meta = FileMetaDataset()
            meta.TransferSyntaxUID = ExplicitVRLittleEndian
            ds.file_meta = meta
            ds.save_as(os.path.join(out_directory, f"IM{idx:05d}.dcm"),
                       write_like_original=False)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("file", help="CFL basename")
    parser.add_argument("--out-directory", required=True)
    parser.add_argument("--series-description",
                        default="dl_swin_gan_tpu recon")
    args = parser.parse_args(argv)

    vols = load_images(args.file)                      # [sl, emap, ph, y, x]
    pixels = window_int16(np.abs(vols[:, 0]))          # [sl, ph, y, x]
    os.makedirs(args.out_directory, exist_ok=True)
    try:
        import pydicom  # noqa: F401
    except ImportError:
        out = os.path.join(args.out_directory, "series_int16.npz")
        np.savez_compressed(out, pixels=pixels)
        meta = dict(series_description=args.series_description,
                    shape=list(pixels.shape), dtype="int16",
                    note="pydicom unavailable; raw windowed pixels written")
        with open(os.path.join(args.out_directory, "series_meta.json"),
                  "w") as f:
            json.dump(meta, f, indent=2)
        print(out)
        return out
    write_series(pixels, args.out_directory, args.series_description)
    print(args.out_directory)
    return args.out_directory


if __name__ == "__main__":
    main()
