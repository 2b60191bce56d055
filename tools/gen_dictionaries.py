"""Generate Aruco dictionary bit tables as committed data.

The standard DICT_4X4_50 / DICT_5X5_100 / DICT_6X6_250 marker bit patterns
(the three dictionaries the reference's aruco_dict parameter accepts,
aruco_detector.cpp:59-78) are public constants; we materialize them once
(via OpenCV's renderer, available in this image) into an .npz so the
engine has no runtime OpenCV dependency.  Each marker is rendered at
(markerSize + 2*border) pixels and the inner bit grid read off directly.
"""

import os

import cv2.aruco as aruco
import numpy as np

DICTS = {
    "4X4_50": (aruco.DICT_4X4_50, 4, 50),
    "5X5_100": (aruco.DICT_5X5_100, 5, 100),
    "6X6_250": (aruco.DICT_6X6_250, 6, 250),
}


def main():
    out = {}
    for name, (enum, size, count) in DICTS.items():
        d = aruco.getPredefinedDictionary(enum)
        bits = np.zeros((count, size, size), dtype=np.uint8)
        for i in range(count):
            img = aruco.generateImageMarker(d, i, size + 2)
            inner = img[1:-1, 1:-1]
            bits[i] = (inner > 127).astype(np.uint8)
        out[name] = bits
        print(name, bits.shape, "first marker:\n", bits[0])
    dst = os.path.join(os.path.dirname(__file__), "..", "arslam",
                       "detect", "dictionaries.npz")
    np.savez_compressed(dst, **out)
    print("wrote", dst)


if __name__ == "__main__":
    main()
