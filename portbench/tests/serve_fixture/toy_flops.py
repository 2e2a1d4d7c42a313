"""A toy FLOP count for the CPU tests: two FLOPs a parameter a token the
model must process (the prompt's, and every served token but the last,
whose successor is never asked for)."""


def call_flops(config: dict, batch: int, prompt_len: int,
               new_tokens: int) -> int:
    return 2 * config["toy_params"] * batch * (prompt_len + new_tokens - 1)
