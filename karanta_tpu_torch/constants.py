"""Global constants.

Parity surface with reference karanta/constants.py:3-25, extended with
the package's operating points. Values that define the comparison envelope
(render resolution, context caps) are kept identical to the reference so the
pipeline behaves the same end to end.
"""

import enum
import os

_PKG_ROOT = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

# Render resolution used when generating ground-truth data (reference constants.py:3).
TARGET_IMAGE_DIM = 2048
# Render resolution used by the serving pipeline (reference pipeline.py:1170-1175).
PIPELINE_IMAGE_DIM = 1288

# Prompt template files (reference constants.py:5-8).
PROMPT_PATH = os.path.join(_REPO_ROOT, "configs", "prompts", "data_generation.yaml")
CREATE_TEST_PROMPT_PATH = os.path.join(_REPO_ROOT, "configs", "prompts", "create_tests.yaml")

# Serving-side token budgets (reference pipeline.py:124,280).
MODEL_MAX_CONTEXT = 16384
MAX_OUTPUT_TOKENS_PER_PAGE = 4000
# Stats-only long output threshold (reference pipeline.py:965).
LONG_CONTEXT_THRESHOLD = 32768

# Retry ladder (reference pipeline.py:281).
TEMPERATURE_BY_ATTEMPT = [0.1, 0.1, 0.2, 0.3, 0.5, 0.8, 0.9, 1.0]


class ModelGroup(str, enum.Enum):
    """Teacher-model provider groups (reference constants.py:11-14)."""

    OPENAI = "openai"
    GEMINI = "gemini"
    OLMO_VLLM = "olmo_vllm"


class Model(str, enum.Enum):
    """Known teacher / OCR model identifiers (reference constants.py:17-24)."""

    GPT_4O = "gpt-4o"
    GPT_41 = "gpt-4.1"
    GPT_5 = "gpt-5"
    OLMOCR_7B = "allenai/olmOCR-7B-0725"
    OLMOCR_2_7B = "allenai/olmOCR-2-7B-1025"
    OLMOCR_2_7B_FP8 = "allenai/olmOCR-2-7B-1025-FP8"
