# SPDX-License-Identifier: Apache-2.0
from .generate import Generator, next_power_of_2, sample_token  # noqa: F401
