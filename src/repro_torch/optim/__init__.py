from .adamw import (OptConfig, init as opt_init, step as opt_step,
                    quantize_grads_int8, dequantize_grads_int8)
