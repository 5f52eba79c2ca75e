from .model import (Model, decode_step, greedy_decode, hidden_states,
                    init_caches, init_params, params_from_jax, prefill)

__all__ = ["Model", "decode_step", "greedy_decode", "hidden_states",
           "init_caches", "init_params", "params_from_jax", "prefill"]
