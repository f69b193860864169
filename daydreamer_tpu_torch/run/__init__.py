from .train import train
