from .model import (Model, bind, decode_step, flatten_jax, forward, greedy_decode,
                    hidden_states, init_caches, init_params, loss_fn, model_of,
                    opt_state_from_jax, param_count, params_from_jax, params_of, prefill)

__all__ = ["Model", "bind", "decode_step", "flatten_jax", "forward", "greedy_decode",
           "hidden_states", "init_caches", "init_params", "loss_fn", "model_of",
           "opt_state_from_jax", "param_count", "params_from_jax", "params_of", "prefill"]
