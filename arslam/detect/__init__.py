from arslam.detect.dictionaries import get_dictionary, DICT_NAMES  # noqa: F401
from arslam.detect.reference import detect_markers  # noqa: F401
