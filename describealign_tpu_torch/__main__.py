"""python -m describealign_tpu_torch entry point."""
import multiprocessing

from .cli import command_line_interface

if __name__ == "__main__":
    multiprocessing.freeze_support()
    command_line_interface()
