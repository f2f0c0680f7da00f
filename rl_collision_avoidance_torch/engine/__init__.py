from .env import Env, EnvState, Obs, StepInfo

__all__ = ["Env", "EnvState", "Obs", "StepInfo"]
