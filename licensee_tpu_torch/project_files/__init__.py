from licensee_tpu_torch.project_files.project_file import ProjectFile
from licensee_tpu_torch.project_files.license_file import LicenseFile
from licensee_tpu_torch.project_files.readme_file import ReadmeFile
from licensee_tpu_torch.project_files.package_manager_file import PackageManagerFile

__all__ = ["ProjectFile", "LicenseFile", "ReadmeFile", "PackageManagerFile"]
