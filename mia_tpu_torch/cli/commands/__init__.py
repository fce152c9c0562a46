from .basecommand import BaseCommand
from .visualizecommand import VisualizeCommand

available_commands = [VisualizeCommand]

__all__ = ["BaseCommand", "VisualizeCommand", "available_commands"]
