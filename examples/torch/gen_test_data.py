"""Regenerate the 10-point LAS test fixtures (the reference's
gen_test_data example, pasture-io/examples/gen_test_data.rs — positions
(i,i,i), intensities i*255, ramped attributes per format).

Port of examples/gen_test_data.py to pasture_tpu_torch; each file written
is read back onto the device and checked.

Usage: python examples/torch/gen_test_data.py [output_dir] [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np

from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import read_batch
from pasture_tpu_torch.io.las import LasWriter
from pasture_tpu_torch.io.las.header import LasPointFormat
from pasture_tpu_torch.io.las.layout import point_schema_from_las_format
from pasture_tpu_torch.layout import attributes as att

I = np.arange(10)


def fixture_columns(fmt: LasPointFormat):
    cols = {
        att.POSITION_3D.name: np.stack([I, I, I], 1).astype(np.float64),
        att.INTENSITY.name: (I * 255).astype(np.uint16),
        att.CLASSIFICATION.name: I.astype(np.uint8),
        att.USER_DATA.name: I.astype(np.uint8),
        att.POINT_SOURCE_ID.name: I.astype(np.uint16),
        att.SCAN_DIRECTION_FLAG.name: (I % 2).astype(np.uint8),
        att.EDGE_OF_FLIGHT_LINE.name: (I % 2).astype(np.uint8),
    }
    if fmt.is_extended:
        cols[att.RETURN_NUMBER.name] = I.astype(np.uint8)
        cols[att.NUMBER_OF_RETURNS.name] = I.astype(np.uint8)
        cols[att.CLASSIFICATION_FLAGS.name] = I.astype(np.uint8)
        cols[att.SCANNER_CHANNEL.name] = (I % 4).astype(np.uint8)
        cols[att.SCAN_ANGLE.name] = I.astype(np.int16)
    else:
        cols[att.RETURN_NUMBER.name] = (I % 8).astype(np.uint8)
        cols[att.NUMBER_OF_RETURNS.name] = (I % 8).astype(np.uint8)
        cols[att.SCAN_ANGLE_RANK.name] = I.astype(np.int8)
    if fmt.has_gps_time:
        cols[att.GPS_TIME.name] = (I + 1).astype(np.float64)
    if fmt.has_color:
        cols[att.COLOR_RGB.name] = np.stack(
            [I, (I + 1) << 4, (I + 2) << 8], 1).astype(np.uint16)
    if fmt.has_nir:
        cols[att.NIR.name] = I.astype(np.uint16)
    if fmt.has_waveform:
        cols[att.WAVE_PACKET_DESCRIPTOR_INDEX.name] = I.astype(np.uint8)
        cols[att.WAVEFORM_DATA_OFFSET.name] = I.astype(np.uint64)
        cols[att.WAVEFORM_PACKET_SIZE.name] = I.astype(np.uint32)
        cols[att.RETURN_POINT_WAVEFORM_LOCATION.name] = I.astype(np.float32)
        cols[att.WAVEFORM_PARAMETERS.name] = np.stack(
            [I + 1, I + 2, I + 3], 1).astype(np.float32)
    return cols


def main(out_dir="test_data", device=None):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for number in range(11):
        fmt = LasPointFormat(number)
        schema = point_schema_from_las_format(fmt)
        buf = HostPointBuffer.from_columns(schema, fixture_columns(fmt))
        paths = [out / f"10_points_format_{number}.las"]
        with LasWriter(paths[0], schema) as w:
            w.write(buf)
        if number <= 5:  # LAZ via the native codec (pointwise scheme)
            paths.append(out / f"10_points_format_{number}.laz")
            with LasWriter(paths[1], schema, compressed=True) as w:
                w.write(buf)
        for path in paths:
            batch = read_batch(path, device=device)
            assert int(batch.count) == 10, path
            print("wrote", path)
            written.append(path)
    return written


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", default="test_data")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    main(args.out_dir, args.device)
