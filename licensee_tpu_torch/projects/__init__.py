from licensee_tpu_torch.projects.project import Project
from licensee_tpu_torch.projects.fs_project import FSProject
from licensee_tpu_torch.projects.git_project import GitProject, InvalidRepository
from licensee_tpu_torch.projects.github_project import GitHubProject, RepoNotFound

__all__ = [
    "Project",
    "FSProject",
    "GitProject",
    "GitHubProject",
    "InvalidRepository",
    "RepoNotFound",
]
