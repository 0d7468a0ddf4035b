"""Environment-variable roots. Own copy of
imgcomp_cvpr_tpu/utils/constants.py (ref: constants.py:1-15): the port reads
the same variables, once, when this module is imported.
"""

import os

# Root dir of training data: image folders or TFRecord shards.
RECORDS_ROOT = os.environ.get('RECORDS_ROOT', 'data')

OTHER_CODECS_ROOT = os.environ.get('OTHER_CODECS_ROOT', 'other_codecs')

VALIDATION_DATASETS_ROOT = os.environ.get('VAL_ROOT', '')

CONFIG_BASE_AE = os.environ.get('CONFIG_BASE_AE', '')
CONFIG_BASE_PC = os.environ.get('CONFIG_BASE_PC', '')

NUM_PREPROCESS_THREADS = int(os.environ.get('NUM_PREPROCESS_THREADS', 4))
NUM_CROPS_PER_IMG = int(os.environ.get('NUM_CROPS_PER_IMG', 1))
