"""The models of the JAX model zoo (dense GQA, MLA with MoE, the RG-LRU
hybrid, xLSTM, and the audio and vision stub frontends with the non-causal
encoder), in PyTorch."""

from .io import input_specs, rank_inputs  # noqa: F401
from .specs import ParamSpec, init_params, param_count  # noqa: F401
from .transformer import Model, layer_plan, model_specs  # noqa: F401
from .xlstm import MLSTMState, SLSTMState  # noqa: F401
