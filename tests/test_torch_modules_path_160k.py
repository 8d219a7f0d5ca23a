"""`test_torch_modules_path.py`'s stage 1-2b and stage 3-5 checks on the
160 kbp `pipeline_parity` genome, in a file of their own so that xdist
runs them beside the 2 Mbp substrate's, not after them: the same test
functions, collected here with this module's `runs` fixture."""

import pytest
import torch

# in the order they run there: the stage 3-5 checks last, after the stage
# 1-2b checks of the replay they mask
from test_torch_modules_path import (  # noqa: F401  (collected here)
    _replay, stages, test_gates_all_modules, test_shared_join_and_plans,
    test_verified_module, test_low_copy_rescue,
    test_modules_stage_equals_replay, test_ltr_stage, test_library_stage,
    test_annotation,
)
from test_torch_tir_path import (  # noqa: F401  (autouse)
    _substrate, compile_cache,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=("parity_160k",))
def runs(request):
    contigs, params_kw, align_kw = _substrate(request.param)
    return (request.param, _replay(False, contigs, params_kw, align_kw),
            _replay(True, contigs, params_kw, align_kw))
