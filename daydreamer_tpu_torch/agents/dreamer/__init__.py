from .agent import Agent
